"""Persisted stream-state schema versioning.

A copy of ``cylon_tpu/stream/state.py``.  Every spill the streaming layer
journals (micro-batch frames, partial-aggregate state, probe outputs,
refresh results) records a ``state_version`` in its manifest pass
provenance, and readers validate it through :func:`require_state_version`
BEFORE decoding the spill: the partial layout (column order, combine
identities, the validity-refill convention) is an on-disk contract, and
a layout change that silently misread an old spill would corrupt a
refresh without any checksum noticing.  The version is the reference's,
so a log either package wrote reads in the other.
"""
from __future__ import annotations

from typing import Optional

from ..status import Code, CylonError

#: bump on ANY change to the persisted layout: partial column order,
#: identity-fill convention, watermark/provenance semantics
STATE_SCHEMA_VERSION = 1

#: the provenance field name (manifest JSON)
VERSION_FIELD = "state_version"


def state_provenance(**fields) -> dict:
    """Provenance dict for one stream spill: the schema version plus the
    caller's batch/watermark facts."""
    return {VERSION_FIELD: STATE_SCHEMA_VERSION, **fields}


def require_state_version(provenance: Optional[dict]) -> dict:
    """Validate a spill's recorded schema version before decoding it.

    Raises ``Code.Invalid`` when the provenance is absent (a spill
    journaled by something other than the stream layer, or a pre-stream
    journal) or records a different version (a combine-layout change).
    Returns the provenance dict so call sites can destructure it."""
    if not isinstance(provenance, dict) or VERSION_FIELD not in provenance:
        raise CylonError(
            Code.Invalid,
            "stream spill carries no state schema version — refusing to "
            "decode (not written by the stream layer, or written before "
            "versioning)")
    v = provenance[VERSION_FIELD]
    if int(v) != STATE_SCHEMA_VERSION:
        raise CylonError(
            Code.Invalid,
            f"stream state schema version {v} != supported "
            f"{STATE_SCHEMA_VERSION} — refusing to decode a spill whose "
            f"partial layout this build cannot interpret")
    return provenance
