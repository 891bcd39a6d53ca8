"""Hand-written CUDA kernels for Hopper and their builder (``build.py``)."""
