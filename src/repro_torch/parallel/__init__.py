"""Tensor parallelism of the port: logical-axis sharding rules
(``sharding``) and the serving engine's tensor-parallel plan (``tp``), on
``torch.distributed``."""
