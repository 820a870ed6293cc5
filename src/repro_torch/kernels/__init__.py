"""Hand-written CUDA kernels (``csrc/``), their wrappers, their plain
PyTorch versions (``ref``) and the device dispatch (``ops``)."""
