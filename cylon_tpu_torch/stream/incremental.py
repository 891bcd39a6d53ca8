"""Incremental refresh over a StreamTable's frozen micro-batch log.

A copy of ``cylon_tpu/stream/incremental.py``.  Two query shapes, one
exactness contract:

``GroupByQuery``
    The partial/combine/finalize decomposition, turned incremental: each
    refresh computes the delta batches' partial aggregates
    (``ops/groupby.py::hash_groupby`` over the ``groupby_partial_plan``
    layout), combines them with the persisted partial state in one pass
    (a live-first STABLE compaction, then ``hash_groupby`` with the
    combine ops, padded to the state capacity), persists the new state as
    a checksummed spill (part id = watermark), and finalizes with
    ``parallel/ops.py::finalize_groupby_columns``.  NUNIQUE has no
    partial/combine decomposition, so it refreshes in ``full`` mode
    (concatenate + one local group-by); ``explain()`` says which and why.

``JoinQuery``
    Incremental join against a STATIC dimension table: the dimension side
    is uploaded once, only delta fact batches probe it, and per-batch
    probe outputs are journaled so a refresh replays committed probes
    from the spill.

The exactness oracle: the refresh result at watermark N is bit-identical
to ``recompute_cold()``, a from-scratch fold over the frozen batches
0..N-1 with no journal in the loop.  What carries it:

* the queries run on a LOCAL one-shard context (the first device of the
  ``ctx`` they are given, or the CUDA card), whatever the caller's mesh;
* batch boundaries are part of the durable contract (StreamTable), so
  the order of the float combines is pinned by the log;
* every capacity in the fold (batch pad, state pad, regrowth) is a pure
  function of the log, so a cold replay derives the same padded shapes,
  and the same shapes through the same ops give the same bits: a float
  sum takes ``segmented_scan`` or ``torch.cumsum`` at a fixed shape, never
  ``scan_1d`` (``ops/segments.py`` routes only int32 prefix sums there),
  and the combine's compaction is ``torch.argsort(stable=True)``.

The reference's jit cache becomes a cache of built callables under the
same keys (``_cached_kernel``), with ``config.trace_cache_token`` folded
in and its ``plan_cache.hit`` / ``plan_cache.miss`` counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import column as colmod
from .. import config
from .. import durable
from .. import exec as exec_mod
from ..column import Column
from ..context import CylonContext
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..ops import groupby as groupby_mod
from ..ops.groupby import AggOp
from ..parallel import ops as par_ops
from ..status import Code, CylonError
from ..utils import pow2ceil
from . import state as state_mod

#: manifest level persisted aggregate state / probe outputs live at
STATE_LEVEL = 0


# ---------------------------------------------------------------------------
# knob accessors
# ---------------------------------------------------------------------------

def batch_cap() -> int:
    """CYLON_TPU_STREAM_BATCH_CAP: fixed device capacity per micro-batch
    (0 = derive ``pow2ceil(rows)`` per batch)."""
    return int(config.knob("CYLON_TPU_STREAM_BATCH_CAP"))


def state_cap() -> int:
    """CYLON_TPU_STREAM_STATE_CAP: floor for the persisted-state group
    capacity (0 = derive from the first batch's group count; state
    regrows by the deterministic overflow-restart rule either way)."""
    return int(config.knob("CYLON_TPU_STREAM_STATE_CAP"))


def _local_context(ctx: Optional[CylonContext]) -> CylonContext:
    """The one-shard context a query runs on: the first device of
    ``ctx`` (its mesh is ignored, so every world runs the same program),
    or the CUDA card (raising without one)."""
    return CylonContext.Init(None if ctx is None else ctx.devices[0])


# ---------------------------------------------------------------------------
# the callable cache: a second refresh over same-shaped deltas is all hits
# ---------------------------------------------------------------------------

_KERNELS: Dict[tuple, object] = {}


def _cached_kernel(key: tuple, build):
    full = (key, config.trace_cache_token())
    fn = _KERNELS.get(full)
    if fn is None:
        obs_metrics.counter_add("plan_cache.miss")
        fn = build()
        _KERNELS[full] = fn
    else:
        obs_metrics.counter_add("plan_cache.hit")
    return fn


def _shapes_key(cols: Sequence[Column]) -> tuple:
    return tuple((tuple(c.data.shape), str(c.data.dtype),
                  c.lengths is not None, str(c.dtype)) for c in cols)


def _take_all(c: Column, perm: torch.Tensor) -> Column:
    """Row-gather every buffer of a column (2-D string matrices too)."""
    return Column(c.data[perm], c.validity[perm],
                  None if c.lengths is None else c.lengths[perm], c.dtype)


def _key_refill(arr: np.ndarray, src_dtype) -> np.ndarray:
    """Reloaded key columns with null groups come back object-typed;
    refill nulls with the SAME payload ``from_numpy`` validity inference
    produces on upload (canonical NaN / NaT), so the re-uploaded state's
    key operands are bit-identical to the device-native state's."""
    if arr.dtype != object:
        return arr
    if np.issubdtype(src_dtype, np.floating):
        mask = np.asarray([v is None for v in arr])
        return np.where(mask, np.nan, arr).astype(src_dtype)
    if np.issubdtype(src_dtype, np.datetime64):
        out = arr.copy()
        out[np.asarray([v is None for v in arr])] = np.datetime64("NaT")
        return out.astype(src_dtype)
    return arr  # strings: from_numpy's missing handling IS the convention


def _concat_cols(a: Column, b: Column) -> Column:
    """Concatenate two columns row-wise; string matrices zero-pad to the
    wider width first (zero pad bytes never change key comparisons)."""
    ad, bd = a.data, b.data
    if ad.ndim == 2:
        w = max(ad.shape[1], bd.shape[1])
        ad = torch.nn.functional.pad(ad, (0, w - ad.shape[1]))
        bd = torch.nn.functional.pad(bd, (0, w - bd.shape[1]))
    lengths = None
    if a.lengths is not None:
        lengths = torch.cat([a.lengths, b.lengths])
    return Column(torch.cat([ad, bd]), torch.cat([a.validity, b.validity]),
                  lengths, a.dtype)


# ---------------------------------------------------------------------------
# incremental group-by
# ---------------------------------------------------------------------------

class GroupByQuery:
    """Incremental group-by over a StreamTable, on the one-shard context
    of ``ctx``'s first device (default: the CUDA card).

    ``refresh()`` returns ``(frame, stats)`` where ``frame`` is a host
    dict of numpy arrays (same naming convention as ``Table.groupby``)
    and ``stats`` carries the incrementality evidence: ``parts_run`` =
    delta batches folded on the device, ``partial_rows`` = delta rows fed
    to the partial pass, ``passes_skipped`` = batches answered from
    persisted state or the result cache.
    """

    def __init__(self, stream, by, agg, ddof: int = 0, *, ctx=None):
        if stream.schema is None:
            raise CylonError(Code.Invalid,
                             "stream has no schema yet — append a batch "
                             "before building a refresh query")
        self.stream = stream
        self.ddof = int(ddof)
        self._ctx = _local_context(ctx)
        self.device = self._ctx.devices[0]
        names = list(stream.schema)
        by_list = [by] if isinstance(by, (str, int, np.integer)) else list(by)
        self.by: List[str] = []
        for b in by_list:
            name = names[b] if isinstance(b, (int, np.integer)) else str(b)
            if name not in names:
                raise CylonError(Code.KeyError,
                                 f"no stream column named {name!r}")
            self.by.append(name)
        self.agg_named = exec_mod._normalize_agg(agg, names)

        # projection fed to the passes: keys, then distinct value columns
        self.val_cols: List[str] = []
        for c, _ in self.agg_named:
            if c not in self.val_cols:
                self.val_cols.append(c)
        self.proj: Tuple[str, ...] = tuple(self.by) + tuple(self.val_cols)
        self.nkeys = len(self.by)
        self.key_idx = tuple(range(self.nkeys))
        self.aggs_idx = tuple(
            (self.nkeys + self.val_cols.index(c), op)
            for c, op in self.agg_named)
        self.out_names = tuple(self.by) + tuple(
            f"{op.name.lower()}_{c}" for c, op in self.agg_named)

        #: NUNIQUE has no partial/combine decomposition: full recompute
        self.incremental = all(op != AggOp.NUNIQUE
                               for _, op in self.agg_named)

        if self.incremental:
            # the partial layout, plus an always-carried COUNT partial per
            # value column: with it the identity refill of a reloaded
            # spill (numeric_fill) is exactly equivalent to device-native
            # validity masking (finalize derives an all-null group's
            # validity from count > 0)
            plist, pindex = par_ops.groupby_partial_plan(self.aggs_idx)
            for ci, _ in self.aggs_idx:
                if (ci, AggOp.COUNT) not in pindex:
                    pindex[(ci, AggOp.COUNT)] = len(plist)
                    plist.append((ci, AggOp.COUNT))
            self.partial_list = tuple(plist)
            self.partial_index = dict(pindex)
            self.final_aggs = tuple(
                (self.nkeys + i, groupby_mod.combine_op(pop))
                for i, (_, pop) in enumerate(self.partial_list))
            self._state_names = tuple(
                [f"k{i}" for i in range(self.nkeys)]
                + [f"p{i}" for i in range(len(self.partial_list))])
        else:
            self.partial_list = ()
            self.partial_index = {}
            self.final_aggs = ()
            self._state_names = ()

        self.spec = ("stream_groupby", self.stream.name, tuple(self.by),
                     tuple((c, op.name) for c, op in self.agg_named),
                     self.ddof)

        # persisted partial-aggregate state: its own pinned run journal
        self._state_journal = None
        if self.incremental:
            fp = durable.run_fingerprint("stream_state", self.spec, ())
            self._state_journal = durable.open_run(fp, "stream_state")
            if self._state_journal is not None:
                self._state_journal.pin()

    # -- device passes ----------------------------------------------------

    def _upload_batch(self, arrs: Dict[str, np.ndarray], cap: int):
        return tuple(colmod.from_numpy(np.asarray(arrs[n]), capacity=cap,
                                       device=self.device)
                     for n in self.proj)

    def _partial(self, cols, rows: int):
        key = ("stream_partial", self.spec, _shapes_key(cols))

        def build():
            key_idx, aggs, ddof = self.key_idx, self.partial_list, self.ddof

            def fn(cs, count):
                return groupby_mod.hash_groupby(cs, count, key_idx, aggs,
                                                ddof)
            return fn

        pcols, pm = _cached_kernel(key, build)(cols, rows)
        return pcols, int(pm)

    def _combine(self, scols, gs: int, S: int, dcols, gd: int, B: int):
        """One pass: compact live state and delta partial rows to the
        front (a stable argsort keeps the combine order pinned to batch
        order), re-group on the keys with the combine ops, cut back to
        the state capacity.  Returns (new state cols, new group count)."""
        key = ("stream_combine", self.spec, S, B, _shapes_key(scols),
               _shapes_key(dcols))

        def build():
            nkeys, final_aggs, ddof = self.nkeys, self.final_aggs, self.ddof

            def fn(st, gs_, dt, gd_):
                cat = tuple(_concat_cols(a, b) for a, b in zip(st, dt))
                dev = cat[0].device
                live = torch.cat([torch.arange(S, device=dev) < gs_,
                                  torch.arange(B, device=dev) < gd_])
                # stable sort: live rows first, relative order preserved
                perm = torch.argsort((~live).to(torch.int32), stable=True)
                packed = tuple(_take_all(c, perm) for c in cat)
                out_cols, ng = groupby_mod.hash_groupby(
                    packed, gs_ + gd_, tuple(range(nkeys)), final_aggs,
                    ddof)
                return tuple(c.with_capacity(S) for c in out_cols), ng
            return fn

        ncols, nm = _cached_kernel(key, build)(scols, gs, dcols, gd)
        return ncols, int(nm)

    def _finalize(self, scols, m: int):
        key = ("stream_finalize", self.spec, _shapes_key(scols))

        def build():
            nkeys, aggs, pindex, ddof = (self.nkeys, self.aggs_idx,
                                         self.partial_index, self.ddof)

            def fn(st):
                outs = par_ops.finalize_groupby_columns(
                    list(st), nkeys, aggs, pindex, ddof)
                # pass-through aggs surface all-null groups as NULL via
                # the always-carried COUNT partial: device-native state
                # (validity False) and reloaded state (identity-refilled,
                # validity True) converge on the same output validity
                for pos, (ci, op) in enumerate(aggs):
                    if op in (AggOp.SUM, AggOp.MIN, AggOp.MAX, AggOp.SUMSQ):
                        cnt = st[nkeys + pindex[(ci, AggOp.COUNT)]]
                        c = outs[nkeys + pos]
                        outs[nkeys + pos] = Column(
                            c.data, c.validity & (cnt.data > 0), c.lengths,
                            c.dtype)
                return tuple(outs)
            return fn

        out_cols = _cached_kernel(key, build)(scols)
        return {name: colmod.to_numpy(c, m)
                for name, c in zip(self.out_names, out_cols)}

    # -- the fold ---------------------------------------------------------

    def _fold(self, frames, state0, start: int, pass_guard):
        """Fold batches ``start..`` onto ``state0`` (or from scratch).

        Every capacity decision is a pure function of the log: batch cap
        = knob or pow2ceil(rows); state cap = knob floor or pow2ceil of
        the first partial's group count; on combine overflow the state
        regrows to pow2ceil(overflowed count) and the WHOLE fold
        restarts from batch 0, so a cold replay re-derives the exact
        regrowth cascade.  Returns ``(cols, m, S, folded_batches,
        folded_rows)``."""
        bcap = batch_cap()
        floor = state_cap()
        while True:
            if state0 is not None:
                cols, m, S = state0
                i = start
            else:
                cols, m, S = None, 0, 0
                i = 0
            folded = 0
            frows = 0
            overflow = 0
            for j in range(i, len(frames)):
                if pass_guard is not None:
                    pass_guard()
                _names, arrs, rows = frames[j]
                B = bcap or pow2ceil(rows)
                if rows > B:
                    raise CylonError(
                        Code.Invalid,
                        f"batch {j} has {rows} rows > "
                        f"CYLON_TPU_STREAM_BATCH_CAP={B}")
                pcols, pm = self._partial(self._upload_batch(arrs, B), rows)
                folded += 1
                frows += rows
                if cols is None:
                    S = max(floor, pow2ceil(pm))
                    cols, m = tuple(c.with_capacity(S) for c in pcols), pm
                    continue
                ncols, nm = self._combine(cols, m, S, pcols, pm, B)
                if nm > S:
                    overflow = nm
                    break
                cols, m = ncols, nm
            if not overflow:
                return cols, m, S, folded, frows
            # deterministic regrowth: restart the fold from batch 0 at the
            # grown capacity (a cold replay hits the identical overflow at
            # the identical batch and regrows identically)
            obs_metrics.counter_add("stream.state_regrown")
            floor = max(floor, pow2ceil(overflow))
            state0, start = None, 0

    # -- persisted state --------------------------------------------------

    def _state_frame(self, cols, m: int) -> Dict[str, np.ndarray]:
        return {n: colmod.to_numpy(c, m)
                for n, c in zip(self._state_names, cols)}

    def _load_state(self, js, part: int):
        """Reload the persisted partial state at ``part`` (schema-version
        gated before decode).  Returns ``(cols, m, S)`` or None."""
        try:
            prov = state_mod.require_state_version(
                js.pass_provenance(STATE_LEVEL, part))
        except CylonError:
            return None
        loaded = js.load_pass(STATE_LEVEL, part)
        if loaded is None:
            return None
        frame, m = loaded
        m = int(m)
        S = int(prov.get("cap", 0))
        if S <= 0 or m > S or tuple(frame.keys()) != self._state_names:
            return None
        cols = []
        for i, name in enumerate(self._state_names):
            arr = np.asarray(frame[name])
            if i >= self.nkeys:
                ci, pop = self.partial_list[i - self.nkeys]
                arr = exec_mod._numeric_fill(arr, pop, self._src_dtype(ci))
            else:
                arr = _key_refill(arr, self._src_dtype(i))
            cols.append(colmod.from_numpy(arr, capacity=S,
                                          device=self.device))
        return tuple(cols), m, S

    def _src_dtype(self, ci: int):
        """Numpy dtype of projection column ``ci`` (for the identity
        refill of all-null partials), from the first committed batch."""
        name = self.proj[ci]
        for _names, arrs, _rows in self.stream.frames():
            return np.asarray(arrs[name]).dtype
        raise CylonError(Code.Invalid, "stream has no batches")

    # -- refresh ----------------------------------------------------------

    def result_fingerprint(self, watermark: int) -> str:
        """The refresh result's journal fingerprint: folds the query
        spec AND the high watermark, so a refresh at an unchanged
        watermark is a pure cache hit and an append moves the key."""
        return durable.run_fingerprint(
            "stream_refresh", self.spec + (("watermark", int(watermark)),),
            ())

    def refresh(self, pass_guard=None):
        wm = self.stream.watermark
        if wm == 0:
            raise CylonError(Code.Invalid,
                             "refresh before the first committed batch")
        mode = "incremental" if self.incremental else "full"
        jr = durable.open_run(self.result_fingerprint(wm), "stream_refresh")
        with obs_spans.span("stream.refresh", stream=self.stream.name,
                            watermark=wm, op="groupby", mode=mode):
            if jr is not None and jr.is_complete():
                cached = self._load_result(jr)
                if cached is not None:
                    frame, rows = cached
                    obs_metrics.counter_add("stream.refresh_cached")
                    return frame, {
                        "parts_run": 0, "passes_skipped": 1,
                        "partial_rows": 0, "rows": int(rows),
                        "watermark": wm, "mode": mode,
                        "stream": self.stream.name}
            if self.incremental:
                frame, rows, stats = self._refresh_incremental(wm,
                                                               pass_guard)
            else:
                frame, rows, stats = self._refresh_full(wm, pass_guard)
            if jr is not None:
                jr.record_pass(
                    0, 0, frame, rows,
                    provenance=state_mod.state_provenance(watermark=wm))
                jr.record_done(1, rows)
            obs_metrics.counter_add("stream.refreshes")
            stats.update(watermark=wm, mode=mode, rows=int(rows),
                         stream=self.stream.name)
            return frame, stats

    def _load_result(self, jr):
        # version-gate the result spill before decoding it
        try:
            state_mod.require_state_version(jr.pass_provenance(0, 0))
        except CylonError:
            return None
        return jr.load_pass(0, 0)

    def _refresh_incremental(self, wm: int, pass_guard):
        frames = self.stream.frames()[:wm]
        js = self._state_journal
        state0, start = None, 0
        if js is not None:
            for p in sorted((p for p in js.parts_at_level(STATE_LEVEL)
                             if p <= wm), reverse=True):
                got = self._load_state(js, p)
                if got is not None:
                    state0, start = got, p
                    break
        cols, m, S, folded, frows = self._fold(frames, state0, start,
                                               pass_guard)
        if js is not None and (folded or state0 is None):
            js.record_pass(
                STATE_LEVEL, wm, self._state_frame(cols, m), m,
                provenance=state_mod.state_provenance(
                    watermark=wm, groups=m, cap=S))
        frame = self._finalize(cols, m)
        obs_metrics.counter_add("stream.rows_delta", frows)
        return frame, m, {"parts_run": folded,
                          "passes_skipped": max(0, wm - folded),
                          "partial_rows": frows, "state_groups": m,
                          "state_cap": S}

    def _refresh_full(self, wm: int, pass_guard):
        from ..table import Table, _local_groupby

        frames = self.stream.frames()[:wm]
        if pass_guard is not None:
            pass_guard()
        total = sum(r for _, _, r in frames)
        arrays = [np.concatenate([np.asarray(arrs[n]) for _, arrs, _ in
                                  frames]) for n in self.proj]
        t = Table.from_numpy(self.proj, arrays, ctx=self._ctx,
                             capacity=pow2ceil(total))
        res = _local_groupby(t, self.key_idx, self.aggs_idx, self.ddof)
        frame = res.to_numpy()
        rows = len(next(iter(frame.values()))) if frame else 0
        obs_metrics.counter_add("stream.rows_delta", total)
        return frame, rows, {"parts_run": wm, "passes_skipped": 0,
                             "partial_rows": total}

    # -- oracle -----------------------------------------------------------

    def recompute_cold(self):
        """The exactness oracle: a from-scratch fold over the frozen
        concatenation of batches 0..watermark-1 with NO journal in the
        loop.  ``refresh()`` must be bit-identical to this."""
        wm = self.stream.watermark
        if wm == 0:
            raise CylonError(Code.Invalid, "stream has no batches")
        if not self.incremental:
            frame, _rows, _stats = self._refresh_full(wm, None)
            return frame
        cols, m, _S, _folded, _frows = self._fold(
            self.stream.frames()[:wm], None, 0, None)
        return self._finalize(cols, m)

    # -- introspection ----------------------------------------------------

    def describe(self) -> dict:
        reason = ("all aggregates decompose into partial+combine"
                  if self.incremental else
                  "NUNIQUE has no partial/combine decomposition")
        return {"kind": "groupby", "stream": self.stream.name,
                "watermark": self.stream.watermark,
                "mode": "incremental" if self.incremental else "full",
                "reason": reason, "by": list(self.by),
                "aggs": [f"{op.name.lower()}({c})"
                         for c, op in self.agg_named],
                "partials": len(self.partial_list),
                "durable": self._state_journal is not None}

    def explain(self) -> str:
        from ..plan import explain as explain_mod

        return explain_mod.explain_refresh(self.describe())

    def close(self, unpin: bool = False) -> None:
        if self._state_journal is not None and unpin:
            self._state_journal.unpin()

    def to_spec(self) -> dict:
        """JSON-safe round-trippable spec (serve submission)."""
        agg: Dict[str, list] = {}
        for c, op in self.agg_named:
            agg.setdefault(c, []).append(op.name.lower())
        return {"kind": "groupby", "stream": self.stream.name,
                "by": list(self.by), "agg": agg, "ddof": self.ddof}


# ---------------------------------------------------------------------------
# incremental join against a static dimension table
# ---------------------------------------------------------------------------

class JoinQuery:
    """Incremental fact-stream ⋈ static-dimension join, on the one-shard
    context of ``ctx``'s first device (default: the CUDA card).

    The dimension side is uploaded ONCE; each delta batch probes it in a
    shard-local join at the batch's own capacity, and per-batch probe
    outputs are journaled (part id = batch id) so committed probes replay
    from the spill.  The result is the concatenation of per-batch outputs
    in batch order."""

    def __init__(self, stream, dim, on=None, left_on=None, right_on=None,
                 how: str = "inner", algorithm: str = "hash", *, ctx=None):
        if stream.schema is None:
            raise CylonError(Code.Invalid,
                             "stream has no schema yet — append a batch "
                             "before building a refresh query")
        self.stream = stream
        self.how = str(how)
        if self.how not in ("inner", "left"):
            # per-batch probes can't express dim-preserving joins: an
            # unmatched dim row would re-emit once per batch
            raise CylonError(Code.Invalid,
                             f"incremental join supports how='inner'/'left' "
                             f"(fact-side), not {self.how!r}")
        self.algorithm = str(algorithm)
        self._ctx = _local_context(ctx)
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise CylonError(Code.Invalid,
                             "join needs on= or left_on=/right_on=")

        def as_list(v):
            return [v] if isinstance(v, (str, int, np.integer)) else list(v)

        self.left_on = [str(c) for c in as_list(left_on)]
        self.right_on = [str(c) for c in as_list(right_on)]

        dim_names, dim_arrs = exec_mod._as_host_frame(dim)
        self._dim_names = tuple(str(n) for n in dim_names)
        self._dim_arrs = {str(k): np.asarray(v) for k, v in dim_arrs.items()}
        self._dim_rows = (len(self._dim_arrs[self._dim_names[0]])
                          if self._dim_names else 0)
        self._dim_table = None  # built lazily, once

        from .table import _content_fingerprint

        self.spec = ("stream_join", self.stream.name,
                     _content_fingerprint(self._dim_names, self._dim_arrs),
                     tuple(self.left_on), tuple(self.right_on), self.how,
                     self.algorithm)
        self.incremental = True

        fp = durable.run_fingerprint("stream_state", self.spec, ())
        self._state_journal = durable.open_run(fp, "stream_state")
        if self._state_journal is not None:
            self._state_journal.pin()

    def _dim(self):
        if self._dim_table is None:
            from ..table import Table

            self._dim_table = Table.from_numpy(
                self._dim_names,
                [self._dim_arrs[n] for n in self._dim_names],
                ctx=self._ctx, capacity=pow2ceil(self._dim_rows))
        return self._dim_table

    def _probe_batch(self, arrs: Dict[str, np.ndarray], rows: int):
        """Join ONE fact batch against the uploaded dimension table."""
        from ..table import Table

        bcap = batch_cap()
        B = bcap or pow2ceil(rows)
        if rows > B:
            raise CylonError(
                Code.Invalid,
                f"batch has {rows} rows > CYLON_TPU_STREAM_BATCH_CAP={B}")
        names = self.stream.schema
        lt = Table.from_numpy(names, [np.asarray(arrs[n]) for n in names],
                              ctx=self._ctx, capacity=B)
        out = lt.join(self._dim(), left_on=self.left_on,
                      right_on=self.right_on, how=self.how,
                      algorithm=self.algorithm)
        return out.to_numpy()

    def _load_probe(self, js, part: int):
        """Reload one committed per-batch probe output (version-gated
        before decode)."""
        try:
            state_mod.require_state_version(
                js.pass_provenance(STATE_LEVEL, part))
        except CylonError:
            return None
        return js.load_pass(STATE_LEVEL, part)

    def result_fingerprint(self, watermark: int) -> str:
        return durable.run_fingerprint(
            "stream_refresh", self.spec + (("watermark", int(watermark)),),
            ())

    def refresh(self, pass_guard=None):
        wm = self.stream.watermark
        if wm == 0:
            raise CylonError(Code.Invalid,
                             "refresh before the first committed batch")
        jr = durable.open_run(self.result_fingerprint(wm), "stream_refresh")
        with obs_spans.span("stream.refresh", stream=self.stream.name,
                            watermark=wm, op="join", mode="incremental"):
            if jr is not None and jr.is_complete():
                try:
                    state_mod.require_state_version(jr.pass_provenance(0, 0))
                    cached = jr.load_pass(0, 0)
                except CylonError:
                    cached = None
                if cached is not None:
                    frame, rows = cached
                    obs_metrics.counter_add("stream.refresh_cached")
                    return frame, {
                        "parts_run": 0, "passes_skipped": 1,
                        "partial_rows": 0, "rows": int(rows),
                        "watermark": wm, "mode": "incremental",
                        "stream": self.stream.name}
            frames = self.stream.frames()[:wm]
            js = self._state_journal
            outputs: List[Tuple[Dict[str, np.ndarray], int]] = []
            probed = 0
            probed_rows = 0
            for b, (_names, arrs, rows) in enumerate(frames):
                loaded = None if js is None else self._load_probe(js, b)
                if loaded is not None:
                    outputs.append((loaded[0], int(loaded[1])))
                    continue
                if pass_guard is not None:
                    pass_guard()
                frame_b = self._probe_batch(arrs, rows)
                out_rows = (len(next(iter(frame_b.values())))
                            if frame_b else 0)
                probed += 1
                probed_rows += rows
                if js is not None:
                    js.record_pass(
                        STATE_LEVEL, b, frame_b, out_rows,
                        provenance=state_mod.state_provenance(
                            batch=b, rows=out_rows))
                outputs.append((frame_b, out_rows))
            frame = self._concat_outputs(outputs)
            rows = sum(r for _, r in outputs)
            if jr is not None:
                jr.record_pass(
                    0, 0, frame, rows,
                    provenance=state_mod.state_provenance(watermark=wm))
                jr.record_done(1, rows)
            obs_metrics.counter_add("stream.refreshes")
            obs_metrics.counter_add("stream.rows_delta", probed_rows)
            return frame, {"parts_run": probed,
                           "passes_skipped": wm - probed,
                           "partial_rows": probed_rows, "rows": int(rows),
                           "watermark": wm, "mode": "incremental",
                           "stream": self.stream.name}

    @staticmethod
    def _concat_outputs(outputs):
        if not outputs:
            return {}
        names = list(outputs[0][0].keys())
        return {n: np.concatenate([np.asarray(f[n]) for f, _ in outputs])
                for n in names}

    def recompute_cold(self):
        """Oracle: probe every frozen batch from scratch, no journal."""
        wm = self.stream.watermark
        if wm == 0:
            raise CylonError(Code.Invalid, "stream has no batches")
        outputs = []
        for _names, arrs, rows in self.stream.frames()[:wm]:
            frame_b = self._probe_batch(arrs, rows)
            out_rows = len(next(iter(frame_b.values()))) if frame_b else 0
            outputs.append((frame_b, out_rows))
        return self._concat_outputs(outputs)

    def describe(self) -> dict:
        return {"kind": "join", "stream": self.stream.name,
                "watermark": self.stream.watermark, "mode": "incremental",
                "reason": "static dim broadcasts once; only delta fact "
                          "rows probe (broadcast-hash rule)",
                "on": [f"{l}={r}" for l, r in zip(self.left_on,
                                                  self.right_on)],
                "how": self.how, "dim_rows": self._dim_rows,
                "durable": self._state_journal is not None}

    def explain(self) -> str:
        from ..plan import explain as explain_mod

        return explain_mod.explain_refresh(self.describe())

    def close(self, unpin: bool = False) -> None:
        if self._state_journal is not None and unpin:
            self._state_journal.unpin()


# ---------------------------------------------------------------------------
# serve-layer entry point
# ---------------------------------------------------------------------------

def query_from_spec(spec: dict, ctx=None):
    """Rebuild a refresh query from its JSON spec on ``ctx``'s first
    device (default: the CUDA card): any process sharing the durable dir
    replays the stream's batch log from the manifest and runs the
    identical refresh."""
    from .table import StreamTable

    if not isinstance(spec, dict) or "stream" not in spec:
        raise CylonError(Code.Invalid,
                         "refresh spec must be a dict with a 'stream' key")
    stream = StreamTable(str(spec["stream"]))
    if stream.watermark == 0:
        raise CylonError(Code.Invalid,
                         f"stream {spec['stream']!r} has no committed "
                         f"batches in the durable journal")
    kind = str(spec.get("kind", "groupby"))
    if kind == "groupby":
        return GroupByQuery(stream, spec.get("by", []),
                            dict(spec.get("agg", {})),
                            ddof=int(spec.get("ddof", 0)), ctx=ctx)
    if kind == "join":
        return JoinQuery(stream, dict(spec.get("dim", {})),
                         left_on=spec.get("left_on") or spec.get("on"),
                         right_on=spec.get("right_on") or spec.get("on"),
                         how=str(spec.get("how", "inner")),
                         algorithm=str(spec.get("algorithm", "hash")),
                         ctx=ctx)
    raise CylonError(Code.Invalid, f"unknown refresh kind {kind!r}")


def run_refresh(query_or_spec, *args, ctx=None, pass_guard=None, **kwargs):
    """The serve layer's ``refresh`` op runner: a built query object (run
    on its own device) or its JSON spec (rebuilt on ``ctx``'s first
    device).  Idempotent by construction: the result fingerprint folds
    the high watermark."""
    del args, kwargs
    q = query_or_spec
    if isinstance(q, dict):
        q = query_from_spec(q, ctx=ctx)
    return q.refresh(pass_guard=pass_guard)
