"""Host transports of the port.

``control.py`` holds the control plane's one-shot JSON requests over TCP
(``cylon_tpu/net/control.py``), which the journal's peer server and its
replication pulls (``durable_sync.py``) ride.  The rest of the JAX
package's ``cylon_tpu/net/`` (channels, the byte-level all-to-all, the
communicator configs) comes with the elastic gang, ROADMAP.md queue A
item 11b.
"""
