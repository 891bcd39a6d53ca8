"""The distributed rung over an in-process mesh of shards (port of
``cylon_tpu/parallel``): hash targets, the exchange, distributed ops."""
