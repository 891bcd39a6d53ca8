"""Data-plane wire codec: engine values and journal blobs on a JSON line.

A copy of ``cylon_tpu/router/wire.py``.  The control plane
(``net/control.py``) speaks one JSON object per line; a data-plane verb
additionally carries whole frames or raw journal files.  This module maps
them onto that line and back, bit-exactly:

- a **frame** (dict of host numpy columns, the chunked engine's
  currency) rides as Arrow IPC bytes (``io/arrow_io.py``'s exact
  round-trip encoding, the one the durable journal spills) in base64
  under a reserved marker key; a bare ``numpy`` array rides as a
  single-column frame; numpy scalars collapse to Python scalars;
  dicts/lists/tuples recurse; JSON-native scalars pass through;
- a **blob** (a spill file, a manifest) rides byte-verbatim with an
  in-band sha256 (:func:`blob_b64`), which the journal's replication and
  read-repair verify end to end (``durable_sync.py``);
- a classified `CylonError` rides as its code name, message and
  retry-after hint (:func:`classified` / :func:`classified_error`).

Anything else is a classified `Code.SerializationError`.
:func:`request_key` hashes the canonical encoding of a request (content
only: no tenant, deadline or trace header).  The router that routes on
it is ROADMAP.md queue A item 11b's.
"""
from __future__ import annotations

import base64
import hashlib
import json
from typing import Dict, Optional, Tuple

import numpy as np

from .. import config
from ..io import arrow_io
from ..status import Code, CylonError

#: reserved marker keys of the encoded forms; a user dict carrying one
#: of these is refused rather than silently mis-decoded on the far side
FRAME_KEY = "__cylon_frame__"
ARRAY_KEY = "__cylon_array__"
_MARKERS = (FRAME_KEY, ARRAY_KEY)


def router_max_line() -> int:
    """``CYLON_TPU_ROUTER_MAX_LINE_BYTES``: wire cap for one data-plane
    message (``cylon_tpu/router/service.py:98``), at least 64 KiB."""
    return max(1 << 16, int(config.knob("CYLON_TPU_ROUTER_MAX_LINE_BYTES")))


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def _ipc_b64(frame: Dict) -> str:
    """Frame -> base64 Arrow IPC, with pyarrow's refusals (2-D arrays,
    structured dtypes, ...) re-raised CLASSIFIED — nothing escapes this
    module unclassified, on either side of the wire."""
    try:
        return _b64(arrow_io.frame_to_ipc_bytes(frame))
    except CylonError:
        raise
    except Exception as e:
        raise CylonError(
            Code.SerializationError,
            f"cannot encode frame for the router wire: "
            f"{type(e).__name__}: {e} (columns must be 1-D numpy "
            f"arrays)") from e


def encode_value(v):
    """One engine value -> a JSON-safe tree (see module docstring)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return {ARRAY_KEY: _ipc_b64({"v": v})}
    if isinstance(v, dict):
        if any(k in v for k in _MARKERS):
            raise CylonError(
                Code.SerializationError,
                f"dict carries a reserved router wire marker key "
                f"({[k for k in _MARKERS if k in v]})")
        if v and all(isinstance(c, np.ndarray) for c in v.values()):
            return {FRAME_KEY: _ipc_b64(v)}
        return {str(k): encode_value(c) for k, c in v.items()}
    if isinstance(v, (list, tuple)):
        return [encode_value(c) for c in v]
    raise CylonError(
        Code.SerializationError,
        f"cannot ship a {type(v).__name__} over the router wire "
        f"(frames = dicts of numpy columns, arrays, and JSON scalars "
        f"only; plan handles are process-local — submit them to a "
        f"replica's QueryService directly)")


def _ipc_from_b64(data) -> Dict:
    """base64 Arrow IPC -> frame, with decode-side refusals (corrupt
    base64, malformed IPC, a non-string where the marker promised one)
    re-raised CLASSIFIED — the decode side honours the same
    nothing-escapes-unclassified contract as :func:`_ipc_b64`."""
    try:
        return arrow_io.frame_from_ipc_bytes(base64.b64decode(data))
    except CylonError:
        raise
    except Exception as e:
        raise CylonError(
            Code.SerializationError,
            f"cannot decode frame from the router wire: "
            f"{type(e).__name__}: {e}") from e


def decode_value(v):
    """Inverse of :func:`encode_value`."""
    if isinstance(v, dict):
        if FRAME_KEY in v:
            return _ipc_from_b64(v[FRAME_KEY])
        if ARRAY_KEY in v:
            return _ipc_from_b64(v[ARRAY_KEY])["v"]
        return {k: decode_value(c) for k, c in v.items()}
    if isinstance(v, list):
        return [decode_value(c) for c in v]
    return v


def encode_payload(args, kwargs) -> Dict:
    """``(args, kwargs)`` of one submit call -> the wire payload."""
    return {"args": [encode_value(a) for a in args],
            "kwargs": {str(k): encode_value(v)
                       for k, v in sorted(kwargs.items())}}


def payload_nbytes(v) -> int:
    """JSON-encoded size of an encoded payload tree, without paying a
    second ``json.dumps`` of the dominant content.  The base64 frame
    strings under the marker keys are escape-free ASCII by construction,
    so their length IS their encoded length; everything else (user
    strings may be escape-heavy — ``ensure_ascii`` inflates non-ASCII
    6x — plus scalars and keys) is measured with a per-node ``dumps``,
    which is exact and only touches the small parts.  The result never
    materially underestimates the real line, so the client's wire-cap
    pre-check stays a deterministic classified refusal instead of a
    mid-send connection drop."""
    if isinstance(v, str):
        return len(json.dumps(v))
    if isinstance(v, dict):
        if any(k in v for k in _MARKERS):
            # {marker: base64}: count, don't re-dump megabytes
            return 2 + sum(len(str(k)) + len(c) + 6 for k, c in v.items())
        return 2 + sum(len(json.dumps(str(k))) + 2 + payload_nbytes(c)
                       for k, c in v.items())
    if isinstance(v, (list, tuple)):
        return 2 + sum(payload_nbytes(c) + 1 for c in v)
    return len(json.dumps(v))  # None/bool/int/float — exact


def decode_payload(payload: Dict) -> Tuple[list, Dict]:
    if not isinstance(payload, dict):
        raise CylonError(Code.SerializationError,
                         f"malformed route payload: {type(payload).__name__}")
    args = [decode_value(a) for a in payload.get("args", [])]
    kwargs = {k: decode_value(v)
              for k, v in (payload.get("kwargs") or {}).items()}
    return args, kwargs


def request_key(op: str, payload: Dict) -> str:
    """Cache-affinity key: sha256 over the canonical encoded request.
    Content-only by construction — the payload has no tenant, deadline,
    or trace fields (those are top-level route verb fields)."""
    doc = json.dumps({"op": str(op), "payload": payload},
                     sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(doc.encode()).hexdigest()[:32]


def jsonable(obj, *, _depth: int = 0):
    """Best-effort JSON sanitizer for stats dicts riding the wire: numpy
    scalars/arrays become Python scalars/lists, sets sort, unknown
    objects stringify.  Lossy on purpose (stats are reporting, not
    data) — results always ride :func:`encode_value` instead."""
    if _depth > 8:
        return str(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): jsonable(v, _depth=_depth + 1)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v, _depth=_depth + 1) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(str(v) for v in obj)
    return str(obj)


# ---------------------------------------------------------------------------
# checksum-verified blobs (the journal replication data plane)
# ---------------------------------------------------------------------------

def blob_b64(data: bytes) -> Dict:
    """Raw journal bytes (a spill file, a manifest) -> wire dict with an
    in-band sha256.  Unlike the frame markers above this does NOT decode
    the payload — replication ships spills byte-verbatim so the copy is
    bit-identical by construction; the digest rides along so the far
    side can refuse a damaged transfer without interpreting it."""
    if not isinstance(data, (bytes, bytearray)):
        raise CylonError(Code.SerializationError,
                         f"blob_b64 wants bytes, got {type(data).__name__}")
    data = bytes(data)
    return {"blob": _b64(data), "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data)}


def blob_from_b64(d: Dict, expect_sha: Optional[str] = None) -> bytes:
    """Inverse of :func:`blob_b64`, verifying the in-band digest AND (when
    given) the caller's independent expectation — read-repair passes the
    LOCAL manifest's sha256 here, so a peer serving consistent-but-
    different bytes (a diverged journal) is refused as loudly as a torn
    transfer.  Mismatches classify `Code.IOError`."""
    try:
        data = base64.b64decode(d["blob"])
    except Exception as e:
        raise CylonError(Code.SerializationError,
                         f"cannot decode journal blob from the wire: "
                         f"{type(e).__name__}: {e}") from e
    digest = hashlib.sha256(data).hexdigest()
    if digest != d.get("sha256"):
        raise CylonError(Code.IOError,
                         f"journal blob damaged in transfer: sha256 "
                         f"{digest[:12]} != advertised "
                         f"{str(d.get('sha256'))[:12]}")
    if expect_sha is not None and digest != expect_sha:
        raise CylonError(Code.IOError,
                         f"peer journal blob diverges from the local "
                         f"manifest: sha256 {digest[:12]} != expected "
                         f"{expect_sha[:12]}")
    return data


# ---------------------------------------------------------------------------
# classified errors over the wire
# ---------------------------------------------------------------------------

def classified(err: CylonError) -> Dict:
    """A `CylonError` as a wire dict the far side can re-raise."""
    return {"code": err.code.name, "msg": err.msg,
            "retry_after_s": err.retry_after_s}


def classified_error(d: Optional[Dict]) -> CylonError:
    """Wire dict -> `CylonError` (unknown code names classify as
    `Code.UnknownError` rather than failing the decode)."""
    d = d or {}
    try:
        code = Code[str(d.get("code"))]
    except KeyError:
        code = Code.UnknownError
    ra = d.get("retry_after_s")
    return CylonError(code, str(d.get("msg", "remote classified failure")),
                      retry_after_s=float(ra) if ra is not None else None)
