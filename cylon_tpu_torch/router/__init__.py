"""The fleet router's wire codec.

``wire.py`` (``cylon_tpu/router/wire.py``) encodes frames, arrays,
checksummed journal blobs and classified errors on one JSON line; the
journal's peer server and replication pulls (``durable_sync.py``) use
it.  The query router, its replicas and the fleet-wide result cache
(``cylon_tpu/router/service.py``, ``replica.py``) are ROADMAP.md queue A
item 11b's.
"""
