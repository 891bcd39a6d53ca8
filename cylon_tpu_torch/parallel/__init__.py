"""The distributed rung over a mesh of shards, in one process or over a
process group (port of ``cylon_tpu/parallel``): hash targets, the
exchange, distributed ops."""
