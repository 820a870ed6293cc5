"""Checkpoint IO of the port (``ckpt.py``: npz + manifest, async save)."""
