"""``CYLON_TPU_LOCK_RECORD=1`` for the port's fleet suites: the port's
counterpart of the session hook in ``tests/conftest.py``, which records
the JAX package's locks only.

A suite imports ``port_lock_record``; with the knob on, every lock the
module's tests create is made under the port's recorder
(``cylon_tpu_torch.analysis.locks.record_locks``), and an observed
held -> acquired edge missing from the port's lock-order golden, or one
the static lock graph cannot derive, fails the module (CY204), as
``python -m cylon_tpu_torch.analysis --lockgraph`` would.  With the knob
off the fixture does nothing.
"""
import contextlib

import pytest

from cylon_tpu_torch.analysis import locks


@contextlib.contextmanager
def recording():
    """Record the block's lock ordering when the knob is on and check it
    on exit; yields the recorder, or None when the knob is off."""
    if not locks.record_enabled():
        yield None
        return
    rec = locks.LockRecorder()
    with locks.record_locks(rec):
        yield rec
    inv = locks.package_inventory()
    found = locks.check_lockgraph(rec.observed(inv), locks.static_edges(inv))
    assert not found, "\n".join(f.render() for f in found)


@pytest.fixture(scope="module", autouse=True)
def port_lock_record():
    with recording() as rec:
        yield rec
