"""Data parallelism across GPUs (``mesh.py``)."""
