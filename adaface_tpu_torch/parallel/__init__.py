"""Data and tensor parallelism of the port (`parallel/mesh.py`)."""
