"""StreamTable: an append-only log of micro-batches, journaled durably.

A copy of ``cylon_tpu/stream/table.py``.  Each ``append`` journals the
batch's host frame as a new fsync'd pass of a ``durable.RunJournal`` with
batch id, row count and a content fingerprint in the pass provenance, so
the frozen batch log IS the manifest and a ``kill -9`` mid-append costs
at most the in-flight batch.  Re-running the same append sequence after
a crash resumes bit-identically: an append whose content fingerprint
matches the committed batch at the replay cursor is a no-op, and the
first new batch lands at the high watermark.

Batch ``i`` is pass ``(0, i)``; the **watermark** is the count of
contiguous committed batches, and the concatenation of batches
``0..watermark-1`` in batch order is the frozen table every refresh and
every cold recompute agrees on (batch boundaries order the float
combines).  The run dir is **pinned** (``RunJournal.pin``) while the
stream is open, so the size-cap LRU GC never evicts live stream state.

Both fingerprints are knob-blind and keyed like the reference's (the log
by the stream's name, a batch by its content), so a log the JAX package
appended replays here, and the other way round.  The table is host-side:
its queries (``stream/incremental.py``) upload batches to their device.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import durable
from .. import exec as exec_mod
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..status import Code, CylonError
from . import state as state_mod

#: manifest level all batch passes live at (part id == batch id)
BATCH_LEVEL = 0


def _content_fingerprint(names: Sequence[str],
                         arrs: Dict[str, np.ndarray]) -> str:
    """Content-only batch fingerprint: full coverage of every column
    (durable's position-mixed fold), deliberately EXCLUDING knobs and
    salts — the batch log is raw data, its identity must not move when
    a trace knob flips (results do; the refresh fingerprint folds knobs
    via ``durable.run_fingerprint``)."""
    h = hashlib.sha256()
    h.update(b"cylon_tpu.stream.batch.v1")
    for name in names:
        durable._update_array(h, str(name), np.asarray(arrs[name]))
    return h.hexdigest()


def _stream_fingerprint(name: str) -> str:
    """The append log's journal fingerprint: name-keyed and knob-blind
    (same reasoning as the content fingerprint — the LOG is identity,
    not computation)."""
    h = hashlib.sha256()
    h.update(f"cylon_tpu.stream.append.v1|{name}".encode())
    return h.hexdigest()


class StreamTable:
    """Append-only micro-batch log with a durable, crash-resumable
    journal.  ``append`` takes the same DataFrame / dict-of-arrays /
    Table inputs the out-of-core engine does."""

    def __init__(self, name: str):
        self.name = str(name)
        self.fingerprint = _stream_fingerprint(self.name)
        #: committed batches, in batch order: (names, arrs, rows, fp)
        self._frames: List[Tuple[Tuple[str, ...], Dict[str, np.ndarray],
                                 int, str]] = []
        self._names: Optional[Tuple[str, ...]] = None
        #: idempotent-replay cursor: how many already-committed batches
        #: this process has re-appended (crash-resume re-runs)
        self._replay_cursor = 0
        self._journal = durable.open_run(self.fingerprint, "stream_append")
        if self._journal is not None:
            self._journal.pin()
            self._replay()

    # -- journal replay ---------------------------------------------------

    def _replay(self) -> None:
        """Rebuild the in-memory batch log from the manifest: contiguous
        committed batches from 0 up to the first gap (a torn tail from a
        crash mid-append is re-executed by the re-run, never guessed
        at).  Every spill decode is schema-version-gated."""
        j = self._journal
        assert j is not None
        for bid in j.parts_at_level(BATCH_LEVEL):
            if bid != len(self._frames):
                break  # gap: everything after a lost batch is dead tail
            prov = state_mod.require_state_version(
                j.pass_provenance(BATCH_LEVEL, bid))
            loaded = j.load_pass(BATCH_LEVEL, bid)
            if loaded is None:
                break  # corrupt/missing spill: the re-run re-appends it
            frame, rows = loaded
            names = tuple(frame.keys())
            if self._names is None:
                self._names = names
            self._frames.append((names, frame, int(rows),
                                 str(prov.get("content_fp", ""))))
        if self._frames:
            obs_spans.instant("stream.resume", stream=self.name,
                              batches=len(self._frames))

    # -- the append/watermark contract ------------------------------------

    @property
    def watermark(self) -> int:
        """High watermark: number of committed batches.  A refresh at an
        unchanged watermark is a pure cache hit (the refresh fingerprint
        folds this value)."""
        return len(self._frames)

    @property
    def schema(self) -> Optional[Tuple[str, ...]]:
        """Column names, known after the first batch (None before)."""
        return self._names

    def append(self, data) -> int:
        """Append one micro-batch; returns its batch id.

        Idempotent under crash-resume: re-appending a batch whose
        content fingerprint matches the already-committed batch at the
        replay cursor is a no-op (returns the existing id), so re-running
        the same append script after a ``kill -9`` converges on the
        identical batch log."""
        names, arrs = exec_mod._as_host_frame(data)
        if not names:
            raise CylonError(Code.Invalid, "cannot append an empty frame "
                                           "(no columns)")
        rows = len(np.asarray(arrs[names[0]]))
        for k in names:
            if len(np.asarray(arrs[k])) != rows:
                raise CylonError(Code.Invalid,
                                 f"ragged batch: column {k!r} has "
                                 f"{len(np.asarray(arrs[k]))} rows != {rows}")
        names_t = tuple(str(n) for n in names)
        if self._names is not None and names_t != self._names:
            raise CylonError(
                Code.Invalid,
                f"batch schema {names_t} != stream schema {self._names} "
                f"(append-only streams never reshape)")
        arrs = {str(k): np.asarray(v) for k, v in arrs.items()}
        fp = _content_fingerprint(names_t, arrs)

        if self._replay_cursor < len(self._frames):
            committed = self._frames[self._replay_cursor]
            if committed[3] == fp:
                # crash-resume re-run replaying an already-durable batch
                self._replay_cursor += 1
                obs_spans.instant("stream.append_replayed",
                                  stream=self.name,
                                  batch=self._replay_cursor - 1)
                return self._replay_cursor - 1
            # divergence from the journal: this is genuinely new data —
            # stop replay-dedupe and append at the watermark
            self._replay_cursor = len(self._frames)

        bid = len(self._frames)
        with obs_spans.span("stream.append", stream=self.name, batch=bid,
                            rows=rows):
            if self._journal is not None:
                self._journal.record_pass(
                    BATCH_LEVEL, bid, arrs, rows,
                    provenance=state_mod.state_provenance(
                        batch=bid, rows=rows, content_fp=fp))
        if self._names is None:
            self._names = names_t
        self._frames.append((names_t, arrs, rows, fp))
        self._replay_cursor = len(self._frames)
        obs_metrics.counter_add("stream.batches_appended")
        obs_metrics.counter_add("stream.rows_appended", rows)
        return bid

    def frames(self) -> List[Tuple[Tuple[str, ...], Dict[str, np.ndarray],
                                   int]]:
        """The frozen batch log: [(names, host frame, rows)] in batch
        order — the concatenation every oracle recomputes over."""
        return [(n, f, r) for (n, f, r, _) in self._frames]

    def batch_rows(self) -> List[int]:
        return [r for (_, _, r, _) in self._frames]

    def close(self, unpin: bool = False) -> None:
        """Release the stream.  ``unpin=True`` re-admits the batch log
        to LRU GC (the stream is retired, not merely idle)."""
        if self._journal is not None and unpin:
            self._journal.unpin()

    def __repr__(self) -> str:
        return (f"StreamTable({self.name!r}, watermark={self.watermark}, "
                f"durable={self._journal is not None})")
