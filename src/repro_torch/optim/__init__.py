"""Optimizers of the port (``adamw.py``)."""
