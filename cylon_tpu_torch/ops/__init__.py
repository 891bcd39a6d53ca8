"""Relational kernels over torch tensors (port of ``cylon_tpu/ops``)."""
