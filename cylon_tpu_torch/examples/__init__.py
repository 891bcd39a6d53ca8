"""The BASELINE example drivers on the port (the twins of the top-level
``examples/`` package, which drives the JAX package): each makes its own
data from a seed (``tpch_data``), runs one BASELINE.json config through
the port's public API and prints one JSON record.  They run on the CUDA
card unless given ``device=`` (``"cpu"`` in the tests); ``run_baselines``
runs them all."""
