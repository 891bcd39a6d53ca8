"""The benchmark of ``cylon_tpu_torch`` on an NVIDIA H100: one command
runs one cell of ``BENCHMARK.json`` once (``python3 -m benchmark.run``).
Read ``benchmark/README.md``."""
