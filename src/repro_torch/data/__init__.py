"""Data pipeline of the port (``synthetic.py``: the checkpointable
synthetic token stream)."""
