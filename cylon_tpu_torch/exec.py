"""Out-of-core execution: key-domain passes for inputs larger than the
card's memory.

The port of ``cylon_tpu/exec.py``'s single-device engine (reference:
docs/docs/arch.md:146-162 scales by adding MPI ranks; here the key domain
is split into P disjoint parts and one part at a time streams through the
same pass program):

- because parts partition the key domain, a join pass needs only that
  part's rows from BOTH sides, so every join type is exact per pass;
- a group-by whose keys pin down the partitioning key is FINAL per pass
  (host concatenation replaces any cross-pass combine); otherwise each
  pass emits PARTIAL aggregate states (SUM/COUNT/SUMSQ, reference
  groupby/groupby.cpp:23-73) and one small device group-by combines them;
- the host holds the full inputs (numpy); each pass uploads ~1/P of the
  rows at one capacity shared by every pass, so device memory is bounded
  by the pass, not the input.

Planning is host numpy, copied from the JAX package so pass ids agree bit
for bit: ``range`` splits on sample quantiles of an order-preserving
uint64 prefix of the first key column, ``hash`` mixes every key column's
full content through a splitmix64 finalizer, and ``auto`` starts with
range and flips to hash when the planned passes come out unbalanced.

A pass that runs out of device memory splits every remaining part in two
(``_RefinablePlan``) and resumes at the failed part; transient failures
retry in place (``resilience``).  Before the rebuild the failed pass's
tensors are released (the exception's frames cleared) and the caching
allocator's free blocks returned, so the smaller rebuild does not fail on
memory the dead pass still holds.

Every pass program joins by the configured algorithm, sort-merge or hash
(``algo=``).  Each pass runs on the engine's device, ``ctx.devices[0]``,
or the CUDA card when no ``ctx`` is given; without a card it raises,
never falling back to the CPU.  A ``ctx`` of several shards shards every
pass over its mesh instead (``_chunked_distributed``: the public
``distributed_join`` and group-by per pass, each pass retried under
``ctx.collective_retry_policy()``).

The standalone operators stream the same way with no join:
``chunked_groupby`` (and ``chunked_unique``, a group-by with no
aggregates) partitions on the group keys, ``chunked_sort`` on ranges of
the first sort key emitted in key order, ``chunked_repartition`` on
contiguous row blocks hashed to ``world`` targets by the murmur3 kernel.
With ``CYLON_TPU_DURABLE_DIR`` set, the one-shard engines (join,
join -> group-by, group-by, unique, sort) journal every completed pass
(``durable.RunJournal``) and a fresh process re-invoking the same run
loads the journaled passes instead of running them; a mesh or
process-group engine runs unjournaled, as the JAX package's does.
Elastic execution is not ported (ROADMAP.md queue A, item 11b).
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import column as colmod
from . import config, dtypes, durable, resilience
from .config import JoinConfig, JoinType
from .context import CylonContext
from .obs import fleet as obs_fleet
from .obs import metrics as obs_metrics
from .obs import spans as obs_spans
from .ops import groupby as groupby_mod
from .ops import join as join_mod
from .ops.groupby import AggOp
from .parallel import plane as plane_mod
from .utils import pow2ceil
from .status import Code, CylonError, Status


# ---------------------------------------------------------------------------
# host frames
# ---------------------------------------------------------------------------

def _as_host_frame(obj) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Normalize a pandas DataFrame / dict-of-arrays / Table to
    (ordered names, dict of host numpy columns)."""
    if isinstance(obj, dict):
        # stringify KEYS AND NAMES together — a names list of raw int
        # keys against a str-keyed dict would crash every lookup
        return ([str(k) for k in obj],
                {str(k): np.asarray(v) for k, v in obj.items()})
    if hasattr(obj, "shards") and hasattr(obj, "to_numpy") \
            and hasattr(obj, "names"):          # a Table of this package
        return list(obj.names), obj.to_numpy()
    if hasattr(obj, "columns") and hasattr(obj, "__getitem__"):
        # a DataFrame, recognised by its shape rather than by importing
        # pandas (the package never imports it)
        return ([str(c) for c in obj.columns],
                {str(c): np.asarray(obj[c].to_numpy()) for c in obj.columns})
    raise CylonError(Code.Invalid,
                     f"expected DataFrame/dict/Table, got {type(obj)}")


_U63 = np.uint64(1) << np.uint64(63)


def _key_prefix_u64(a: np.ndarray) -> np.ndarray:
    """Order-preserving uint64 planning prefix: equal keys ALWAYS map to
    equal prefixes (the partition-correctness invariant); distinct keys
    may collide (strings beyond eight codepoints), which only affects
    pass balance.  Nulls/NaNs collapse to one prefix each, matching the
    device kernels' null-equality grouping."""
    a = np.asarray(a)
    if a.dtype.kind in ("U", "S", "O"):
        cp = _codepoints(a, 8)       # str() coercion: None -> "None", fine
        if cp is None:
            return np.zeros(0, np.uint64)
        # one byte per leading codepoint (clamped at 255: clamping can
        # only merge prefixes, never split equal keys)
        b = np.minimum(cp, 255).astype(np.uint64)
        out = np.zeros(len(a), np.uint64)
        for i in range(8):
            out = (out << np.uint64(8)) | b[:, i]
        return out
    if a.dtype.kind == "M":
        a = a.astype("datetime64[us]").astype(np.int64)
    if a.dtype.kind == "f":
        b = a.astype(np.float64)
        b = np.where(b == 0, 0.0, b)            # -0.0 groups with +0.0
        b = np.where(np.isnan(b), np.nan, b)    # one NaN payload
        bits = b.view(np.uint64)
        neg = (bits >> np.uint64(63)) == 1
        return np.where(neg, ~bits, bits | _U63)
    if a.dtype.kind == "b":
        return a.astype(np.uint64)
    if a.dtype.kind == "u":
        return a.astype(np.uint64)
    return a.astype(np.int64).view(np.uint64) ^ _U63  # signed bias


def _codepoints(a: np.ndarray, width: Optional[int] = None):
    """[n, width] uint32 codepoint matrix of a string-ish array (None for
    empty input)."""
    if len(a) == 0:
        return None
    u = a.astype("U" if width is None else f"U{width}")
    w = max(u.dtype.itemsize // 4, 1)
    return np.ascontiguousarray(u).view(np.uint32).reshape(len(a), w)


def _mix_u64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (uint64 wraparound arithmetic)."""
    h = np.asarray(h, np.uint64)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def _row_hash_u64(a: np.ndarray) -> np.ndarray:
    """Full-content hash of one key column: unlike the planning prefix,
    DISTINCT string keys sharing a long prefix hash apart, so hash-mode
    passes fan out even when range-mode prefixes collapse.

    NUL codepoints are SKIPPED, not mixed: the codepoint matrix is padded
    to the array's max string length, so mixing the padding would make the
    same string hash differently on sides with different max lengths
    (equal keys would land in different passes and matches would silently
    drop).  Skipping keys the hash to the non-NUL codepoint sequence only
    — a deterministic function of the string value on every side."""
    a = np.asarray(a)
    if a.dtype.kind in ("U", "S", "O"):
        cp = _codepoints(a)
        if cp is None:
            return np.zeros(0, np.uint64)
        h = np.zeros(len(a), np.uint64)
        for i in range(cp.shape[1]):
            c = cp[:, i].astype(np.uint64)
            h = np.where(c == 0, h, _mix_u64(h ^ c))
        return h
    return _mix_u64(_key_prefix_u64(a))


def _hash_u64_cols(key_cols: Sequence[np.ndarray]) -> np.ndarray:
    """Combined full-content uint64 hash of a key-column tuple — the raw
    value behind hash-mode pass ids, also used by `_RefinablePlan` to
    subdivide passes (h % 2P refines h % P)."""
    h = _row_hash_u64(key_cols[0])
    for col in key_cols[1:]:
        h = _mix_u64(h ^ _row_hash_u64(col))
    return h


def _hash_pass_ids(key_cols: Sequence[np.ndarray], passes: int) -> np.ndarray:
    return (_hash_u64_cols(key_cols) % np.uint64(passes)).astype(np.int64)


_PLAN_SAMPLE = 1 << 20


def _plan_pass_ids(keys_l: Sequence[np.ndarray], keys_r: Sequence[np.ndarray],
                   passes: int, mode: str):
    """-> (pass_id_l, pass_id_r, n_passes, mode_used).

    range: sample-quantile edges over the FIRST key column's prefix, so
    passes inherit the reference's range-partition planning shape
    (arrow_partition_kernels.hpp:394-519 sample+histogram) on the host.
    hash: splitmix over all key columns' full content.  auto: range, then
    hash if the largest planned pass exceeds 3x its fair share OR the
    prefix edges fan out less than the (sampled) distinct keys allow —
    e.g. long-common-prefix strings, where range planning degenerates but
    full-content hashing still splits."""
    if mode not in ("range", "hash", "auto"):
        raise CylonError(Code.Invalid, f"bad chunk mode {mode!r}")
    n_l, n_r = len(keys_l[0]), len(keys_r[0])
    total = n_l + n_r
    passes = max(1, min(passes, max(total, 1)))
    if passes == 1 or total == 0:
        return (np.zeros(n_l, np.int32), np.zeros(n_r, np.int32), 1,
                "range" if mode == "auto" else mode)

    stride_l = max(1, (2 * n_l) // _PLAN_SAMPLE)
    stride_r = max(1, (2 * n_r) // _PLAN_SAMPLE)
    if mode in ("range", "auto"):
        pref_l0 = _key_prefix_u64(keys_l[0])
        pref_r0 = _key_prefix_u64(keys_r[0])
        # per-side strided samples (never a full-input concat: at 1B rows
        # that transient would cost gigabytes of host RAM)
        parts = [a[::st] for a, st in ((pref_l0, stride_l),
                                       (pref_r0, stride_r)) if len(a)]
        s = np.sort(np.concatenate(parts))
        pick = np.linspace(0, len(s) - 1, passes + 1)[1:-1].astype(np.int64)
        edges = np.unique(s[pick])
        edges = edges[edges > s[0]]  # an edge at the min would make an
        n_passes = len(edges) + 1    # unconditionally-empty first pass
        pid_l = np.searchsorted(edges, pref_l0, "right").astype(np.int32)
        pid_r = np.searchsorted(edges, pref_r0, "right").astype(np.int32)
        if mode == "range":
            return pid_l, pid_r, n_passes, "range"
        biggest = max(np.bincount(pid_l, minlength=n_passes).max(initial=0),
                      np.bincount(pid_r, minlength=n_passes).max(initial=0))
        fair = max(n_l, n_r) / n_passes
        # sampled distinct-key estimate bounds what any partitioner can do
        hs = [_hash_pass_ids([c[::st] for c in cols], 1 << 62)
              for cols, st in ((keys_l, stride_l), (keys_r, stride_r))
              if len(cols[0])]
        d_hash = len(np.unique(np.concatenate(hs))) if hs else 1
        if biggest <= 3 * fair + 64 and n_passes >= min(passes, d_hash):
            return pid_l, pid_r, n_passes, "range"
        passes = min(passes, max(d_hash, 1))
        if passes == 1:
            return pid_l, pid_r, n_passes, "range"
    return (_hash_pass_ids(keys_l, passes).astype(np.int32),
            _hash_pass_ids(keys_r, passes).astype(np.int32),
            passes, "hash")


# ---------------------------------------------------------------------------
# key/agg resolution helpers
# ---------------------------------------------------------------------------

def _resolve_keys(names, on, side_on, label):
    keys = side_on if side_on is not None else on
    if keys is None:
        raise CylonError(Code.Invalid, "join requires on= or left_on=/right_on=")
    if isinstance(keys, (str, int)):
        keys = [keys]
    out = []
    for k in keys:
        if isinstance(k, (int, np.integer)):
            if not 0 <= k < len(names):
                raise CylonError(Code.KeyError, f"no {label} column {k}")
            out.append(names[k])
        elif k in names:
            out.append(k)
        else:
            raise CylonError(Code.KeyError, f"no {label} column named {k!r}")
    return out


def _check_key_dtypes(arrs_l, lon, arrs_r, ron):
    for ln, rn in zip(lon, ron):
        a, b = np.asarray(arrs_l[ln]), np.asarray(arrs_r[rn])
        kind = dtypes.join_key_mismatch(
            a.dtype.kind in "USO", b.dtype.kind in "USO",
            a.dtype == b.dtype, len(a) == 0 or len(b) == 0)
        if kind is not None:
            raise CylonError(
                Code.Invalid,
                f"join key type mismatch: {ln}:{a.dtype} vs {rn}:{b.dtype} "
                f"(cast the keys to a common type)")


def _joined_names(names_l, names_r, cfg: JoinConfig) -> List[str]:
    """left names ++ right names, prefixing collisions (reference:
    join_utils.cpp build_final_table naming; mirrors table._join_output_names)."""
    collisions = set(names_l) & set(names_r)
    out_l = [cfg.left_prefix + n if n in collisions else n for n in names_l]
    out_r = [cfg.right_prefix + n if n in collisions else n for n in names_r]
    return out_l + out_r


def _normalize_agg(agg, joined_names) -> List[Tuple[str, AggOp]]:
    """{col: op|[ops]} -> ordered [(joined column name, AggOp)]."""
    out = []
    for ref, ops in agg.items():
        if isinstance(ref, (int, np.integer)):
            ref = joined_names[ref]
        if ref not in joined_names:
            raise CylonError(Code.KeyError, f"no joined column named {ref!r}")
        if isinstance(ops, (str, AggOp)):
            ops = [ops]
        for op in ops:
            out.append((ref, AggOp.of(op)))
    return out


_PARTIAL_FILL = {AggOp.SUM: 0, AggOp.SUMSQ: 0, AggOp.COUNT: 0}


def _partials_for(aggs: List[Tuple[str, AggOp]]) -> List[Tuple[str, AggOp]]:
    """Distinct partial (column, op) pairs needed to reconstruct ``aggs``
    across passes; a COUNT partial is always carried per value column so
    the final combine can mask all-null groups."""
    seen: List[Tuple[str, AggOp]] = []
    for name, op in aggs:
        if op == AggOp.NUNIQUE:
            raise CylonError(
                Code.NotImplemented,
                "NUNIQUE across non-final chunk passes is unsupported: "
                "group by the partitioning key (or use passes=1)")
        for pop in groupby_mod.partial_ops(op):
            if (name, pop) not in seen:
                seen.append((name, pop))
        if (name, AggOp.COUNT) not in seen:
            seen.append((name, AggOp.COUNT))
    return seen


def _numeric_fill(arr: np.ndarray, pop: AggOp, src_dtype) -> np.ndarray:
    """Partial columns come back object-typed when a pass had all-null
    groups; refill with the combine identity so they re-upload numeric."""
    if arr.dtype != object:
        return arr
    mask = np.asarray([v is None for v in arr])
    if pop in (AggOp.MIN, AggOp.MAX):
        if np.issubdtype(src_dtype, np.floating):
            fill = np.inf if pop == AggOp.MIN else -np.inf
        elif np.issubdtype(src_dtype, np.integer):
            info = np.iinfo(src_dtype)
            fill = info.max if pop == AggOp.MIN else info.min
        else:
            raise CylonError(
                Code.NotImplemented,
                f"cross-pass {pop.name} combine over all-null groups of "
                f"dtype {src_dtype} — cast the value column to int/float "
                f"or group by the partitioning key")
        out = np.where(mask, fill, arr).astype(src_dtype)
    else:
        out = np.where(mask, _PARTIAL_FILL.get(pop, 0), arr)
        out = out.astype(np.float64 if pop in (AggOp.SUM, AggOp.SUMSQ)
                         else np.int64)
    return out



# ---------------------------------------------------------------------------
# the chunked engine
# ---------------------------------------------------------------------------

def _passes_final(how: JoinType, mode: str, key_positions, nkeys: int) -> bool:
    """True when per-pass group-bys are final (no cross-pass combine):
    equal group tuples must imply equal pass ids.  ``key_positions`` maps
    key position -> set of copies ('l'/'r') present among group columns."""
    need = range(1) if mode == "range" else range(nkeys)
    for pos in need:
        copies = key_positions.get(pos, set())
        if how == JoinType.INNER:
            ok = bool(copies)          # both copies equal on inner rows
        elif how == JoinType.LEFT:
            ok = "l" in copies         # r-copy is null on unmatched rows
        elif how == JoinType.RIGHT:
            ok = "r" in copies
        else:                          # FULL: either copy may be null
            ok = copies == {"l", "r"}
        if not ok:
            return False
    return True


def _str_width(arr: np.ndarray) -> int:
    enc, _, _ = colmod._encode_strings(np.asarray(arr))
    return max(int(enc.dtype.itemsize), 1)


def _grouping_order(pid: np.ndarray) -> np.ndarray:
    """The stable argsort of the pass ids.  Ids below 2^15 sort as int16,
    which numpy radix-sorts in linear time; the order is identical."""
    if int(pid.max(initial=0)) < (1 << 15) and int(pid.min(initial=0)) >= 0:
        pid = pid.astype(np.int16)
    return np.argsort(pid, kind="stable")


class _SideBuilder:
    """Builds one side's per-pass device columns with pass-invariant
    shapes (one shared capacity, fixed string widths) on ``device``."""

    def __init__(self, names, arrs, pass_ids, cap, device):
        self.names = names
        self.arrs = arrs
        self.pass_ids = pass_ids
        self.cap = cap
        self.device = device
        self.widths = {n: _str_width(a) for n, a in arrs.items()
                       if np.asarray(a).dtype.kind in "USO"}
        # pre-group rows by pass id ONCE (stable order preserves each
        # pass's original row order): chunks become contiguous slices, so
        # total host scan work is O(n) per column instead of the mask
        # path's O(n * passes).  Costs one sorted copy per column
        # (CYLON_TPU_CHUNK_PRESORT=0 reverts to masking).
        pid = np.asarray(pass_ids)
        self.presort = (config.knob("CYLON_TPU_CHUNK_PRESORT")
                        and int(pid.max(initial=0)) > 0)
        # single-pass plans skip the grouped copy: the identity argsort +
        # full-column gather would duplicate the whole table for nothing
        if self.presort:
            order = _grouping_order(pid)
            counts = np.bincount(pid, minlength=int(pid.max(initial=0)) + 1)
            self._offsets = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
            self._grouped = {n: np.asarray(a)[order]
                             for n, a in arrs.items()}

    def _columns(self, host, only):
        """Columns at the shared capacity from ``host(name)`` arrays."""
        return tuple(colmod.from_numpy(
            host(n), capacity=self.cap,
            string_width=self.widths.get(n, colmod.DEFAULT_STRING_WIDTH),
            device=self.device)
            for n in (only if only is not None else self.names))

    def _count(self, n: int) -> torch.Tensor:
        return torch.tensor(n, dtype=torch.int32, device=self.device)

    def chunk(self, p: int, only: Optional[Sequence[str]] = None):
        if self.presort:
            if p + 1 < len(self._offsets):
                lo, hi = int(self._offsets[p]), int(self._offsets[p + 1])
            else:
                lo = hi = 0  # pass beyond every planned id: empty chunk
            return (self._columns(lambda n: self._grouped[n][lo:hi], only),
                    self._count(hi - lo))
        sel = self.pass_ids == p
        return (self._columns(lambda n: np.asarray(self.arrs[n])[sel], only),
                self._count(int(np.count_nonzero(sel))))

    def empty_chunk(self, only: Optional[Sequence[str]] = None):
        """Zero-count chunk with the SAME shapes as every real chunk."""
        return (self._columns(lambda n: np.asarray(self.arrs[n])[:0], only),
                self._count(0))


def _block_until_ready(out) -> None:
    """Wait for the device work behind ``out`` (tensors, Columns and
    tuples of them): synchronize every CUDA device it lies on."""
    devs = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devs.add(x.device)
        elif isinstance(x, colmod.Column):
            visit(x.data)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)

    visit(out)
    for dev in devs:
        torch.cuda.synchronize(dev)


def _release_device_memory() -> None:
    """Return the caching allocator's free blocks to the card, so a pass
    rebuilt after an OOM starts from the memory the failed pass held."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _null_mask(a: np.ndarray):
    """Host null mask matching Column.from_numpy's validity inference
    (NaN floats, NaT datetimes, None/NaN objects), or None."""
    if a.dtype.kind == "f":
        return np.isnan(a)
    if a.dtype.kind in "Mm":
        return np.isnat(a)
    if a.dtype.kind == "O":
        return np.asarray([colmod._is_missing(x) for x in a], bool)
    return None


# Optional per-pass progress callback: (passes_done, n_passes,
# out_rows_so_far, run_seconds_so_far).  Set by measurement scripts so a
# deadline mid-sweep still yields an honest partial throughput from the
# COMPLETED passes; None costs nothing.
PASS_PROGRESS_HOOK = None


def _notify_progress(done, n_passes, total, secs) -> None:
    """Invoke PASS_PROGRESS_HOOK non-fatally: a broken progress observer
    must never kill a 64-pass run — it is warned about once and disabled
    for the rest of the process."""
    global PASS_PROGRESS_HOOK
    hook = PASS_PROGRESS_HOOK
    if hook is None:
        return
    try:
        hook(done, n_passes, total, secs)
    except Exception as e:
        import warnings

        PASS_PROGRESS_HOOK = None
        warnings.warn(f"PASS_PROGRESS_HOOK raised {type(e).__name__}: {e}; "
                      f"progress reporting disabled", RuntimeWarning)


class _RefinablePlan:
    """Key-domain pass plan that can subdivide its REMAINING parts when a
    pass exceeds device memory.

    Level-``l`` pass ids are ``pid0 + P0 * (q % 2**l)`` over ``P0 * 2**l``
    parts, so part ``p`` at level ``l`` splits into ``{p, p + P0*2**l}``
    at level ``l+1`` — completed parts keep their frames, only unfinished
    key-domain parts re-run at the finer granularity.

    ``q`` (lazy — costs one host hash pass, paid only on the first OOM):
    hash plans use ``q = h // P0`` so the refined id equals ``h % (P0 *
    2**l)``, the splitmix64 partitioner's natural modulus refinement;
    range plans hash the first key column's order-preserving prefix, so
    the refined id stays a function of the FIRST key alone and
    `_passes_final`'s range-mode finality reasoning survives refinement.
    Either way equal keys share ``q`` on both sides, so refined parts
    still partition the key domain and every per-pass result stays exact.
    """

    def __init__(self, pid_l, pid_r, n_passes: int, mode_used: str,
                 keys_l, keys_r):
        self.pid0_l = np.asarray(pid_l)
        self.pid0_r = np.asarray(pid_r)
        self.p0 = int(n_passes)
        self.mode = mode_used
        self._keys_l = keys_l
        self._keys_r = keys_r
        self._q = None
        self._pid_cache = None  # (level, (pid_l, pid_r)) — one level only

    def _q_for(self, keys, pid0) -> np.ndarray:
        if not keys or len(keys[0]) == 0:
            return np.zeros(len(pid0), np.uint64)
        if self.mode == "hash":
            return _hash_u64_cols(keys) // np.uint64(self.p0)
        return _mix_u64(_key_prefix_u64(keys[0]))

    def part_count(self, level: int) -> int:
        return self.p0 << level

    def pids(self, level: int):
        """(pass_id_l, pass_id_r) int arrays at refinement ``level``.
        The last computed level is memoized: during one OOM recovery the
        redistribution checks and the rebuild all ask for the same level,
        and recomputing would materialize fresh full-table arrays at the
        exact moment the host is under memory pressure."""
        if level == 0:
            return self.pid0_l, self.pid0_r
        if self._pid_cache is not None and self._pid_cache[0] == level:
            return self._pid_cache[1]
        if self._q is None:
            self._q = (self._q_for(self._keys_l, self.pid0_l),
                       self._q_for(self._keys_r, self.pid0_r))
        mask = np.uint64((1 << level) - 1)
        ql, qr = self._q
        pid_l = (self.pid0_l.astype(np.int64)
                 + self.p0 * (ql & mask).astype(np.int64))
        pid_r = (self.pid0_r.astype(np.int64)
                 + self.p0 * (qr & mask).astype(np.int64))
        self._pid_cache = (level, (pid_l, pid_r))
        return pid_l, pid_r

    def split(self, parts: List[int], level: int) -> List[int]:
        """Subdivide each of ``parts`` (ids at ``level``) into its two
        children at ``level + 1``, keeping sibling adjacency."""
        c = self.part_count(level)
        return [s for p in parts for s in (p, p + c)]

    def max_part_rows(self, parts: List[int], level: int) -> Tuple[int, int]:
        """(max left rows, max right rows) over ``parts`` at ``level`` —
        the quantities that size a rebuild's chunk capacities."""
        if not parts:
            return 0, 0
        pid_l, pid_r = self.pids(level)
        c = self.part_count(level)
        sel = np.asarray(parts, np.int64)
        c_l = np.bincount(pid_l, minlength=c)[sel]
        c_r = np.bincount(pid_r, minlength=c)[sel]
        return int(c_l.max(initial=0)), int(c_r.max(initial=0))

    def parts_redistributing(self, parts: List[int], level: int):
        """Bool array aligned with ``parts``: True where splitting moves
        that part's rows between its two children on either side.  A
        False part is a key-domain atom (one hot key, or one shared
        8-byte prefix in range mode): its rows all land in one child of
        its old size, so no refinement depth can shrink it."""
        sel = np.asarray(parts, np.int64)
        out = np.zeros(len(sel), bool)
        if not parts:
            return out
        c0 = self.part_count(level)
        c1 = self.part_count(level + 1)
        for pid in self.pids(level + 1):
            if len(pid) == 0:
                continue
            cnt = np.bincount(pid, minlength=c1)
            out |= (cnt[sel] > 0) & (cnt[sel + c0] > 0)
        return out


def _stream_recoverable(make_exec, plan, t0, *, policy=None, stats=None,
                        prefetch=True, progress=True, journal=None,
                        parts=None, pass_guard=None, device=None):
    """The resilient streaming loop: checkpointed host frames + adaptive
    pass-splitting + bounded transient retry.

    ``make_exec(parts, level)`` builds one level's execution — builders
    and capacities sized over the REMAINING ``parts`` only, one pass
    program — returning ``(chunk, prog, fetch)``.  Completed parts' host
    frames are kept across rebuilds, so recovery RESUMES the stream at
    the failed part instead of restarting it.

    With a ``journal`` (`durable.RunJournal`) the checkpoint outlives the
    process: every completed pass's frame spills to disk and is recorded
    in the run manifest, parts the journal already holds are LOADED
    instead of re-executed (``stats["passes_skipped"]``, metric
    ``durable.passes_skipped``) — a fresh process re-invoking the same
    fingerprinted run resumes mid-plan, surviving ``kill -9``.  A level's
    journaled parts are loaded before ``make_exec`` builds it, which then
    sizes and warms the level over the parts that run only: a fully
    journaled run uploads nothing and launches no kernel, and a resume
    launches the kernels of the parts it runs.

    Failure handling, by classified code (`Status.from_exception`):
    - `Code.OutOfMemory` — every remaining part splits in two (``plan``)
      and the level's execution is rebuilt at roughly half the chunk
      capacity; bounded by ``CYLON_TPU_MAX_OOM_SPLITS``, after which a
      `CylonError(Code.OutOfMemory)` is raised.  ``plan=None`` (callers
      whose pass order is not refinable, e.g. the global sort) disables
      splitting and propagates the failure.
    - `Code.ExecutionError` / `Code.Timeout` (transient comm, or a pass
      deadline fired by ``durable.pass_deadline``) — the failing part
      retries in place under ``policy``'s exponential backoff.
    - anything else — propagates unchanged (a TypeError stays a bug).

    ``parts`` restricts the stream to a subset of the plan's level-0 part
    ids.  ``pass_guard`` is called before every pass; ANY exception it
    raises (a caller's cancellation or request budget) abandons the
    stream and propagates unchanged — guard raises never enter the
    retry/split/quarantine machinery, whatever their code.  ``device``
    is the engine's device, whose memory watermark the passes record.

    Poison-pass quarantine (``CYLON_TPU_QUARANTINE_AFTER`` = N > 0): a
    head part failing with the SAME classified code N consecutive times
    is dropped from the stream and reported in ``stats["quarantined"]``
    (and the journal) instead of wedging retries/refinement forever.
    Only recoverable codes qualify — an unknown code stays a bug.

    Returns ``(t_plan, t_run0, frames, total)`` like the old fixed loop.
    """
    policy = policy or resilience.RetryPolicy.from_env()
    stats = stats if stats is not None else {}
    max_splits = resilience.max_oom_splits() if plan is not None else 0
    n_parts0 = plan.part_count(0) if plan is not None else None
    prefetch = prefetch and config.knob("CYLON_TPU_PREFETCH")

    frames: List[Dict[str, np.ndarray]] = []
    total = 0
    if parts is not None and n_parts0 is not None:
        remaining = sorted(int(p) for p in parts if 0 <= int(p) < n_parts0)
    else:
        remaining = list(range(n_parts0)) if n_parts0 is not None else None
    level = 0
    part_retries = 0  # transient retries of the current head part
    atom_watch: set = set()  # child ids of a head atom already split once
    fail_key = None  # (code, level, head part): quarantine failure tracking
    fail_count = 0
    t_plan = None
    t_run0 = time.perf_counter()
    exec_cache: Dict[int, tuple] = {}
    if journal is not None:
        stats.setdefault("passes_skipped", 0)

    def consume_journaled(part: int, hit) -> None:
        """Append a journal-loaded pass frame in place of executing it.
        Serving a part IS completing it, so the head-part retry/failure
        state resets exactly as it would after an executed pass — the
        next part must start with its full budgets."""
        nonlocal total, part_retries, fail_key, fail_count
        frame, n = hit
        frames.append(frame)
        total += int(n)
        part_retries = 0
        fail_key, fail_count = None, 0
        stats["passes_skipped"] += 1
        obs_spans.instant("durable.pass_skipped", part=int(part),
                          level=level, rows=int(n))
        obs_metrics.counter_add("durable.passes_skipped")

    def quarantine_head(st: Status, msg: str) -> bool:
        """Isolate the head part into the run report (poison-pass
        quarantine); False when quarantine is off, nothing remains, or
        the code is not a recoverable kind (a TypeError stays a bug)."""
        nonlocal remaining, part_retries, fail_key, fail_count
        if durable.quarantine_after() <= 0 or not remaining:
            return False
        if not (st.code == Code.OutOfMemory
                or st.code in resilience.RETRYABLE_CODES):
            return False
        part = remaining[0]
        entry = {"part": int(part), "level": level, "code": st.code.name,
                 "failures": fail_count, "msg": msg}
        stats.setdefault("quarantined", []).append(entry)
        if journal is not None:
            journal.record_quarantine(level, part, st.code.name, msg)
        obs_spans.instant("exec.part_quarantined", part=int(part),
                          level=level, code=st.code.name)
        obs_metrics.counter_add("quarantine.parts")
        obs_fleet.flight_record("quarantine", part=int(part), level=level,
                                code=st.code.name, error=msg[:200])
        remaining = remaining[1:]
        part_retries = 0
        fail_key, fail_count = None, 0
        return True

    def fatal(code: Code, msg: str) -> CylonError:
        """A classified FATAL stream failure (OOM past the split budget,
        retries/deadline exhausted): dump the flight recorder before the
        raise so the post-mortem exists even when tracing was never
        armed."""
        obs_fleet.flight_record("pass_fatal", code=code.name, level=level,
                                part=int(remaining[0]) if remaining else None,
                                error=msg[:200])
        return CylonError(code, msg)

    def recover(e: Exception) -> None:
        """Adjust (remaining, level) for a recoverable failure or raise."""
        nonlocal remaining, level, part_retries, fail_key, fail_count
        st = Status.from_exception(e)
        if (journal is not None and remaining
                and (st.code == Code.OutOfMemory
                     or st.code in resilience.RETRYABLE_CODES)
                and journal.completed(level, remaining[0])):
            # the failing part's result is already durably journaled (a
            # deadline overrun classified AFTER its commit): the loop
            # re-enters and serves it from the journal — no retry budget,
            # no backoff, no quarantine, cannot be fatal.  Checked FIRST:
            # a part whose correct frame sits in the journal must never
            # be quarantined out of the output
            obs_spans.instant("exec.pass_served_from_journal",
                              part=int(remaining[0]), level=level,
                              code=st.code.name)
            return
        # the counter is keyed to the PART's identity, not just the code:
        # an OOM split advances the level (the head's first child keeps
        # its id one level up), so productive refinement starts a fresh
        # count instead of accumulating toward quarantine
        key = (st.code, level, remaining[0] if remaining else None)
        if key == fail_key:
            fail_count += 1
        else:
            fail_key, fail_count = key, 1
        # poison-pass quarantine fires EARLY once the head has failed the
        # same way N consecutive times, and LATE at any point a failure
        # would otherwise be fatal (retry/split budgets exhausted, atoms)
        # — so the knob works regardless of how it compares to the retry
        # budget, and a poisoned part never wedges or kills the stream
        qn = durable.quarantine_after()
        if qn > 0 and fail_count >= qn and quarantine_head(st, st.msg):
            return
        if st.code == Code.OutOfMemory and plan is not None:
            if level >= max_splits:
                msg = (f"pass still exceeds device memory after {level} "
                       f"pass-doublings (CYLON_TPU_MAX_OOM_SPLITS="
                       f"{max_splits}): {st.msg}")
                if quarantine_head(st, msg):
                    return
                raise fatal(Code.OutOfMemory, msg) from e
            # progress check: a split that moves no rows rebuilds an
            # identically-sized program that must OOM again — fail fast
            # instead of burning the whole split budget on no-ops
            moved = plan.parts_redistributing(remaining, level)
            if not moved.any():
                atom_l, atom_r = plan.max_part_rows(remaining, level)
                msg = (f"splitting cannot shrink the failing pass: the "
                       f"remaining parts (largest {atom_l}+{atom_r} rows) "
                       f"are key-domain atoms (single hot key or shared "
                       f"range prefix): {st.msg}")
                if quarantine_head(st, msg):
                    return
                raise fatal(Code.OutOfMemory, msg) from e
            # the FAILING head part may be an atom even when later parts
            # split: allow it ONE split (a smaller output capacity from
            # the other parts can heal an output-driven OOM), then stop.
            # The atom is tracked by id lineage — a part's first child
            # keeps its id, the second gets id + part_count — so an empty
            # sibling completing in between cannot hide the repeat OOM.
            if not moved[0]:
                head = remaining[0]
                if head in atom_watch:
                    atom_l, atom_r = plan.max_part_rows(remaining[:1],
                                                        level)
                    msg = (f"splitting cannot shrink the failing pass: "
                           f"its {atom_l}+{atom_r} rows are one "
                           f"key-domain atom (single hot key or shared "
                           f"range prefix): {st.msg}")
                    if quarantine_head(st, msg):
                        return
                    raise fatal(Code.OutOfMemory, msg) from e
                atom_watch.clear()
                atom_watch.update((head, head + plan.part_count(level)))
            else:
                atom_watch.clear()
            remaining = plan.split(remaining, level)
            level += 1
            part_retries = 0
            # levels are never revisited after a split: free the coarser
            # levels' builders (each holds presorted host copies of both
            # tables) instead of accumulating one copy per refinement
            # while recovering from memory pressure
            exec_cache.clear()
            _release_device_memory()
            stats["oom_splits"] = stats.get("oom_splits", 0) + 1
            obs_spans.instant("exec.oom_split", level=level,
                              remaining_parts=len(remaining))
            obs_metrics.counter_add("oom.refinements")
            return
        if st.code in resilience.RETRYABLE_CODES:
            if part_retries >= policy.max_retries:
                msg = (f"pass retries exhausted after {part_retries + 1} "
                       f"attempts: {st.msg}")
                if quarantine_head(st, msg):
                    return
                raise fatal(st.code, msg) from e
            d = policy.delay(part_retries)
            part_retries += 1
            stats["retries"] = stats.get("retries", 0) + 1
            obs_spans.instant("exec.pass_retry", attempt=part_retries,
                              code=st.code.name)
            obs_metrics.counter_add("retry.attempts")
            if d > 0:
                policy.sleep(d)
            return
        raise e

    while remaining is None or remaining:
        served: Dict[int, tuple] = {}
        if journal is not None:
            if remaining is None and "passes" in stats:
                remaining = list(range(stats["passes"]))
            # load this level's journaled parts BEFORE building its
            # execution (a spill that fails its checksum is rejected here
            # and runs): the execution is then sized over, and warmed
            # on, only the parts that run, and a fully journaled run
            # uploads and launches nothing.  The journaled prefix (a
            # crashed process's completions) is consumed at once
            for p in remaining:
                hit = journal.load_pass(level, p)
                if hit is not None:
                    served[p] = hit
            while remaining and remaining[0] in served:
                consume_journaled(remaining[0], served.pop(remaining[0]))
                remaining = remaining[1:]
            if not remaining:
                break
        todo = (remaining if remaining is None or not served
                else [p for p in remaining if p not in served])
        try:
            cached = exec_cache.get(level)
            # (None: sized for every positional pass, so for any todo)
            if cached is None or (todo is not None
                                  and cached[1] is not None
                                  and not set(todo) <= cached[1]):
                cached = (make_exec(todo, level),
                          None if todo is None else frozenset(todo))
                exec_cache[level] = cached
            ex = cached[0]
        except Exception as e:
            traceback.clear_frames(e.__traceback__)
            recover(e)
            continue
        chunk, prog, fetch = ex
        if remaining is None:  # plan-less callers stream positions 0..n-1
            remaining = list(range(stats["passes"]))
        if t_plan is None:
            t_plan = time.perf_counter() - t0
            t_run0 = time.perf_counter()
        cursor = 0
        cur = fut = nxt = None
        guard_exc = None
        try:
            nxt = chunk(remaining[0]) if prefetch else None
            while cursor < len(remaining):
                if pass_guard is not None:
                    # a guard raise (a caller's cancellation or
                    # request-budget Timeout) ABANDONS the stream
                    # unconditionally — it never enters recover(), so a
                    # retryable-coded Timeout from a request budget cannot
                    # burn retries or quarantine healthy parts
                    try:
                        pass_guard()
                    except Exception as ge:
                        guard_exc = ge
                        raise
                part = remaining[cursor]
                if part in served:  # journaled: loaded, not executed
                    consume_journaled(part, served.pop(part))
                    cursor += 1
                    continue
                deadline = durable.pass_deadline()
                with obs_spans.span("exec.pass", part=part,
                                    level=level) as sp:
                    with deadline:
                        resilience.fault_point("pass_dispatch")
                        cur = nxt if nxt is not None else chunk(part)
                        fut = prog(*cur)               # async dispatch
                        # prefetch the next part that runs (a journaled
                        # one is not in this level's sizing)
                        nxt_part = next((q for q in remaining[cursor + 1:]
                                         if q not in served), None)
                        nxt = (chunk(nxt_part)
                               if prefetch and nxt_part is not None
                               else None)
                        resilience.fault_point("host_fetch")
                        frame, n = fetch(fut)  # blocks; device errors here
                    if obs_spans.events_enabled():
                        sp.set(rows=int(n), bytes=int(sum(
                            a.nbytes for a in frame.values())))
                        obs_metrics.record_hbm_watermark(device)
                    elif cursor == 0 and obs_spans.enabled():
                        # aggregate mode samples the watermark once per
                        # level, not once per pass
                        obs_metrics.record_hbm_watermark(device)
                committed = False
                if journal is not None:
                    # spill + manifest-commit BEFORE the frame counts as
                    # done: a crash inside the journal write re-runs the
                    # pass on resume (at-least-once, never lost)
                    committed = journal.record_pass(level, part, frame,
                                                    int(n))
                if committed:
                    # a deadline overrun classifies AFTER the late frame
                    # is journaled: the Timeout retry serves the result
                    # from the journal instead of re-executing an
                    # identically-slow pass forever
                    deadline.raise_if_fired()
                else:
                    # no journal to serve a retry from: discarding the
                    # late-but-correct frame would condemn every
                    # consistently-slow pass to retry-until-fatal, so
                    # keep it and record the overrun
                    deadline.accept_late()
                total += n
                frames.append(frame)
                cursor += 1
                part_retries = 0
                fail_key, fail_count = None, 0
                stats["parts_run"] = stats.get("parts_run", 0) + 1
                obs_metrics.counter_add("exec.parts_run")
                cur = fut = None
                if progress:
                    _notify_progress(
                        len(frames), len(frames) + len(remaining) - cursor,
                        total, time.perf_counter() - t_run0)
            remaining = []
        except Exception as e:
            # drop the failed pass's device buffers BEFORE re-planning:
            # this frame stays alive through recover()/make_exec(), and a
            # rebuild warmed while the dead full-size buffers are still
            # resident would re-OOM and burn a split for nothing.  The
            # level's program/builder locals go too — their closures hold
            # full presorted host copies of both sides, and keeping them
            # referenced across make_exec would double host memory at the
            # exact moment we're recovering from pressure
            cur = fut = nxt = None
            chunk = prog = fetch = ex = cached = None
            remaining = remaining[cursor:]  # completed frames are kept
            if guard_exc is e:
                raise
            # the exception's frames still hold the failed pass's tensors
            traceback.clear_frames(e.__traceback__)
            recover(e)
    if t_plan is None:
        t_plan = time.perf_counter() - t0
    return t_plan, t_run0, frames, total


def _run_passes(prog, empty_chunk, chunk, n_passes, fetch, t0, *,
                policy=None, stats=None, journal=None, pass_guard=None):
    """Streaming loop over positional passes 0..n-1 with transient-retry
    resilience (no OOM splitting: callers on this entry — the global sort
    — emit passes in an order a hash subdivision would scramble).
    Warms on a zero-count chunk (same shapes, no duplicate host pass
    over the largest chunk), then double-buffers — pass p dispatches
    async while pass p+1's host compression + upload overlap it
    (CYLON_TPU_PREFETCH=0 reverts to strictly serial)."""
    stats = stats if stats is not None else {}
    stats["passes"] = n_passes

    def make_exec(_parts, _level):
        warm = empty_chunk()
        _block_until_ready(prog(*warm))
        del warm
        return chunk, prog, fetch

    return _stream_recoverable(make_exec, None, t0, policy=policy,
                               stats=stats, journal=journal,
                               pass_guard=pass_guard)


def _journal_done(journal, stats: Dict, frames: List, total: int) -> None:
    """After a journaled stream: mark the run complete when nothing was
    quarantined (every pass the plan needed is journaled, so the run is a
    complete result-cache entry), then let the size-cap GC reclaim older
    runs."""
    if journal is not None and not stats.get("quarantined"):
        journal.record_done(len(frames), total)
        durable.gc_journal()


def _concat_host(frames: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if not frames:
        return {}
    out = {}
    for name in frames[0]:
        parts = [f[name] for f in frames]
        if any(p.dtype == object for p in parts):
            parts = [p.astype(object) for p in parts]
        out[name] = np.concatenate(parts)
    return out


def _fetch_frame(names):
    """``fetch`` of a pass program returning (columns, count): the live
    rows as a host frame keyed by ``names``, and their count."""
    def fetch(out):
        cols, count = out
        n = int(count)
        return {name: colmod.to_numpy(c, n)
                for name, c in zip(names, cols)}, n
    return fetch


def chunked_join(left, right, *, on=None, left_on=None, right_on=None,
                 how: str = "inner", passes: int = 4, algo: str = "sort",
                 mode: str = "auto", ctx: Optional[CylonContext] = None,
                 prefetch: bool = True, left_prefix: str = "l_",
                 right_prefix: str = "r_", elastic=None, pass_guard=None):
    """Out-of-core join over host frames (pandas/dict/Table): the key
    domain is split into ``passes`` parts, each part joined on the device
    by one pass program, outputs concatenated on the host.  All four join
    types are exact because parts partition BOTH sides by key.

    ``ctx`` names the device (``ctx.devices[0]``) or, with more than one
    shard, the mesh every pass is sharded over (``_chunked_distributed``);
    the default is the CUDA card.  ``pass_guard`` is called before every
    pass; raising there stops the stream at the next pass boundary.
    ``elastic`` must be None (the elastic gang is not ported).  With
    ``CYLON_TPU_DURABLE_DIR`` set a one-shard run is journaled: a repeat
    (or a fresh process after a crash) loads the journaled passes,
    counted in ``stats["passes_skipped"]``.

    Returns (dict of host columns keyed by joined names, stats)."""
    return _chunked_engine(left, right, on=on, left_on=left_on,
                           right_on=right_on, how=how, group_by=None,
                           agg=None, passes=passes, algo=algo, ddof=0,
                           mode=mode, ctx=ctx, prefetch=prefetch,
                           left_prefix=left_prefix,
                           right_prefix=right_prefix, elastic=elastic,
                           pass_guard=pass_guard)


def chunked_join_groupby_tables(left, right, *, on=None, left_on=None,
                                right_on=None, how: str = "inner",
                                group_by, agg: Dict, passes: int = 4,
                                algo: str = "sort", ddof: int = 0,
                                mode: str = "auto",
                                ctx: Optional[CylonContext] = None,
                                prefetch: bool = True, elastic=None,
                                pass_guard=None):
    """Out-of-core join + group-by over host frames.  ``group_by`` and
    ``agg`` use POST-JOIN column names (collisions prefixed l_/r_, as
    Table.join names them).  When the group keys pin down the
    partitioning key the per-pass group-bys are final; otherwise each
    pass emits partial aggregation states and one small device group-by
    combines them (reference groupby/groupby.cpp:23-73).  ``ctx``,
    ``elastic`` and ``pass_guard`` as in ``chunked_join``.

    Returns (dict of host columns, stats)."""
    if agg is None or group_by is None:
        raise CylonError(Code.Invalid, "group_by and agg are required")
    return _chunked_engine(left, right, on=on, left_on=left_on,
                           right_on=right_on, how=how, group_by=group_by,
                           agg=agg, passes=passes, algo=algo, ddof=ddof,
                           mode=mode, ctx=ctx, prefetch=prefetch,
                           elastic=elastic, pass_guard=pass_guard)


def _engine_context(ctx: Optional[CylonContext]) -> CylonContext:
    """The context the passes run on: ``ctx`` (one shard, or a mesh whose
    shards every pass is split over, in this process or over a process
    group), or the CUDA card (raising without one)."""
    if ctx is None:
        return CylonContext.Init()
    return ctx


def _agree_on_passes(ctx: CylonContext, *plan) -> None:
    """Over a process group every pass's ``Table.from_numpy`` and
    ``to_numpy`` is collective, so every process must run the same
    passes.  One all-gather of a digest of ``plan`` (per-pass row counts,
    the pass count, capacities, names) before the first pass: on a
    mismatch every process raises `Code.Invalid` (all of them took part
    in the gather, so none is left waiting in a pass its peers skip).
    The counterpart of the reference's mesh passes on a multi-host mesh
    (``cylon_tpu/exec.py:1366-1420``), where one controller per host
    plans from the same frames."""
    if ctx.group is None:
        return
    import hashlib

    from .parallel import collectives

    h = hashlib.sha256()
    for part in plan:
        if isinstance(part, np.ndarray):
            a = np.ascontiguousarray(part)
            h.update(f"<{a.dtype.str}{a.shape}>".encode())
            h.update(a.tobytes())
        else:
            h.update(repr(part).encode())
    mine = np.frombuffer(h.digest(), np.uint8).reshape(1, -1).copy()
    every = collectives.process_allgather(mine, ctx.group)
    if not (every == mine).all():
        differ = [p for p in range(every.shape[0])
                  if not (every[p] == every[0]).all()]
        raise CylonError(Code.Invalid,
                         f"process {ctx.GetRank()}: the processes planned "
                         f"different passes (processes {differ} differ from "
                         "process 0); every process must pass the same "
                         "frames to the out-of-core engine")


def _refuse_elastic(elastic) -> None:
    """``elastic=`` (one process's slice of an elastic gang) needs the
    gang and its coordinator, which are not ported yet."""
    if elastic is not None:
        raise CylonError(Code.NotImplemented,
                         "elastic execution is not ported yet (ROADMAP.md "
                         "queue A, item 11b); pass elastic=None")


def _chunked_engine(left, right, *, on, left_on, right_on, how, group_by,
                    agg, passes, algo, ddof, mode, ctx, prefetch,
                    left_prefix: str = "l_", right_prefix: str = "r_",
                    elastic=None, pass_guard=None):
    t_plan0 = time.perf_counter()
    _refuse_elastic(elastic)
    names_l, arrs_l = _as_host_frame(left)
    names_r, arrs_r = _as_host_frame(right)
    lon = _resolve_keys(names_l, on, left_on, "left")
    ron = _resolve_keys(names_r, on, right_on, "right")
    if len(lon) != len(ron):
        raise CylonError(Code.Invalid, "left_on/right_on length mismatch")
    _check_key_dtypes(arrs_l, lon, arrs_r, ron)
    cfg = JoinConfig.of(how, algo, tuple(lon), tuple(ron),
                        left_prefix, right_prefix)
    ctx = _engine_context(ctx)
    jt = cfg.join_type
    joined = _joined_names(names_l, names_r, cfg)
    lidx = tuple(names_l.index(n) for n in lon)
    ridx = tuple(names_r.index(n) for n in ron)

    # -- plan passes over the key domain --------------------------------
    keys_l_arr = [np.asarray(arrs_l[n]) for n in lon]
    keys_r_arr = [np.asarray(arrs_r[n]) for n in ron]
    pid_l, pid_r, n_passes, mode_used = _plan_pass_ids(
        keys_l_arr, keys_r_arr, passes, mode)
    counts_l = np.bincount(pid_l, minlength=n_passes)
    counts_r = np.bincount(pid_r, minlength=n_passes)
    cap_l = pow2ceil(int(max(8, counts_l.max(initial=0))))
    cap_r = pow2ceil(int(max(8, counts_r.max(initial=0))))

    # -- group/agg resolution -------------------------------------------
    gb_names, aggs_req, final_per_pass, fuse_pipeline = None, None, True, False
    if group_by is not None:
        if isinstance(group_by, (str, int, np.integer)):
            group_by = [group_by]
        gb_names = []
        for g in group_by:
            if isinstance(g, (int, np.integer)):
                g = joined[g]
            if g not in joined:
                raise CylonError(Code.KeyError,
                                 f"no joined column named {g!r}")
            gb_names.append(g)
        aggs_req = _normalize_agg(agg, joined)
        # which join-key positions do the group columns pin down?
        key_positions: Dict[int, set] = {}
        n_l = len(names_l)
        for g in gb_names:
            gi = joined.index(g)
            if gi < n_l and gi in lidx:
                key_positions.setdefault(lidx.index(gi), set()).add("l")
            elif gi >= n_l and (gi - n_l) in ridx:
                key_positions.setdefault(ridx.index(gi - n_l), set()).add("r")
        final_per_pass = _passes_final(jt, mode_used, key_positions, len(lon))
        # key-grouped fusion: INNER join output is already adjacent on the
        # full key tuple, so group keys forming a PREFIX of the key tuple
        # need no second sort (pipeline group-by instead of hash group-by)
        every_gb_is_key = all(
            (joined.index(g) < n_l and joined.index(g) in lidx)
            or (joined.index(g) >= n_l and (joined.index(g) - n_l) in ridx)
            for g in gb_names)
        positions = sorted(key_positions)
        fuse_pipeline = (jt == JoinType.INNER and final_per_pass
                         and every_gb_is_key and len(positions) >= 1
                         and positions == list(range(len(positions))))

    if ctx.GetWorldSize() > 1:
        _agree_on_passes(ctx, counts_l, counts_r, n_passes, mode_used,
                         cfg, names_l, names_r,
                         [str(np.asarray(arrs_l[n]).dtype) for n in names_l],
                         [str(np.asarray(arrs_r[n]).dtype) for n in names_r],
                         gb_names, aggs_req, final_per_pass)
        return _chunked_distributed(
            arrs_l, names_l, arrs_r, names_r, lon, ron, cfg, joined,
            pid_l, pid_r, n_passes, counts_l, counts_r, gb_names, aggs_req,
            final_per_pass, ddof, ctx, mode_used, t_plan0,
            pass_guard=pass_guard)

    # -- the per-pass program (per refinement level) ----------------------
    device = ctx.devices[0]
    nk = len(lon)
    kidx = tuple(range(nk))
    if gb_names is not None:
        gidx = tuple(joined.index(g) for g in gb_names)
        if final_per_pass:
            aggs_dev = tuple((joined.index(n), op) for n, op in aggs_req)
            out_names = list(gb_names) + [f"{op.name.lower()}_{n}"
                                          for n, op in aggs_req]
        else:
            partials = _partials_for(aggs_req)
            aggs_dev = tuple((joined.index(n), pop) for n, pop in partials)
            out_names = list(gb_names) + [f"{pop.name.lower()}_{n}"
                                          for n, pop in partials]

    def make_prog(out_cap: int):
        if gb_names is None:
            def prog(cl, cnt_l, cr, cnt_r):
                return join_mod.join_gather(cl, cnt_l, cr, cnt_r, lidx, ridx,
                                            jt, out_cap, algo)
            names = joined
        elif fuse_pipeline and final_per_pass:
            def prog(cl, cnt_l, cr, cnt_r):
                jcols, jm = join_mod.join_gather(
                    cl, cnt_l, cr, cnt_r, lidx, ridx, jt, out_cap, algo,
                    key_grouped=True)
                return groupby_mod.pipeline_groupby(jcols, jm, gidx,
                                                    aggs_dev, ddof)
            names = out_names
        else:
            def prog(cl, cnt_l, cr, cnt_r):
                jcols, jm = join_mod.join_gather(
                    cl, cnt_l, cr, cnt_r, lidx, ridx, jt, out_cap, algo)
                return groupby_mod.hash_groupby(jcols, jm, gidx,
                                                aggs_dev, ddof)
            names = out_names
        return prog, _fetch_frame(names)

    # -- resilient streaming: build one level's execution over the
    #    REMAINING parts only (capacities shrink as passes split), keep
    #    completed host frames, resume on recoverable failures ----------
    plan = _RefinablePlan(pid_l, pid_r, n_passes, mode_used,
                          keys_l_arr, keys_r_arr)
    policy = resilience.RetryPolicy.from_env()
    stats = {"passes": n_passes, "mode": mode_used,
             "chunk_cap": max(cap_l, cap_r), "cap_l": cap_l, "cap_r": cap_r,
             "world": 1}
    journal = None
    if durable.enabled():
        # run identity: op shape x realized plan x input content x
        # result-affecting knobs (``cylon_tpu/exec.py:1216-1221``) — a
        # resumed process recomputes the identical fingerprint and reopens
        # the same journal
        op = "join" if gb_names is None else "join_groupby"
        fp = durable.run_fingerprint(
            op,
            (tuple(lon), tuple(ron), int(jt), int(cfg.algorithm),
             cfg.left_prefix, cfg.right_prefix,
             tuple(gb_names) if gb_names is not None else None,
             tuple((n, int(o)) for n, o in aggs_req)
             if aggs_req is not None else None,
             int(ddof), int(n_passes), mode_used, 1),
            ((names_l, arrs_l), (names_r, arrs_r)))
        journal = durable.open_run(fp, op)

    def make_exec(parts, level):
        pid_l_lvl, pid_r_lvl = plan.pids(level)
        max_l, max_r = plan.max_part_rows(parts, level)
        cap_l_lvl = pow2ceil(max(8, max_l))
        cap_r_lvl = pow2ceil(max(8, max_r))
        build_l = _SideBuilder(names_l, arrs_l, pid_l_lvl, cap_l_lvl, device)
        build_r = _SideBuilder(names_r, arrs_r, pid_r_lvl, cap_r_lvl, device)
        # exact output sizing over key columns only (the reference's
        # two-pass builder Reserve, join_utils.cpp), remaining parts only
        m_max = 0
        for p in parts:
            kc_l, cnt_l = build_l.chunk(p, only=lon)
            kc_r, cnt_r = build_r.chunk(p, only=ron)
            m = int(join_mod.join_row_count(kc_l, cnt_l, kc_r, cnt_r,
                                            kidx, kidx, jt, algo))
            m_max = max(m_max, m)
            del kc_l, kc_r
        out_cap = pow2ceil(max(8, m_max))
        stats.update(chunk_cap=max(cap_l_lvl, cap_r_lvl), cap_l=cap_l_lvl,
                     cap_r=cap_r_lvl, out_cap=out_cap)
        prog, fetch = make_prog(out_cap)

        def chunk(p):
            return build_l.chunk(p) + build_r.chunk(p)

        # warm on the first remaining pass (the kernels build and load at
        # first use) so run_seconds is steady-state
        args0 = chunk(parts[0])
        _block_until_ready(prog(*args0))
        del args0
        return chunk, prog, fetch

    t_plan, t_run0, frames, total = _stream_recoverable(
        make_exec, plan, t_plan0, policy=policy, stats=stats,
        prefetch=prefetch, journal=journal, pass_guard=pass_guard,
        device=device)
    _journal_done(journal, stats, frames, total)
    result = _concat_host(frames)
    if gb_names is not None and not final_per_pass:
        result, total = _combine_partials(result, gb_names, aggs_req,
                                          arrs_l, arrs_r, names_l, names_r,
                                          joined, ddof, ctx)
    t_run = time.perf_counter() - t_run0
    stats["groups" if gb_names is not None else "rows"] = total
    stats["plan_seconds"] = t_plan
    stats["run_seconds"] = t_run
    # the exact-sizing pass inside plan_seconds re-reads the whole input,
    # so a throughput from run_seconds alone understates one-shot cost
    stats["total_seconds"] = t_plan + t_run
    return result, stats


# ---------------------------------------------------------------------------
# cross-pass partial combine
# ---------------------------------------------------------------------------

def _combine_partials(partial_result, gb_names, aggs_req, arrs_l, arrs_r,
                      names_l, names_r, joined, ddof, ctx):
    """One small device group-by, on the engine's context ``ctx``, over the
    concatenated per-pass partial states, then host arithmetic derives the
    requested aggregates (MEAN/VAR/STDDEV from SUM/COUNT/SUMSQ — reference
    KernelTraits decomposition, compute/aggregate_kernels.hpp:38-200)."""
    from .table import Table

    def src_dtype(joined_name):
        i = joined.index(joined_name)
        if i < len(names_l):
            return np.asarray(arrs_l[names_l[i]]).dtype
        return np.asarray(arrs_r[names_r[i - len(names_l)]]).dtype

    partials = _partials_for(aggs_req)
    filled = dict(partial_result)
    for name, pop in partials:
        col = f"{pop.name.lower()}_{name}"
        filled[col] = _numeric_fill(np.asarray(filled[col]), pop,
                                    src_dtype(name))
    t = Table.from_numpy(list(filled), list(filled.values()), ctx=ctx)
    combine_agg = {f"{pop.name.lower()}_{name}":
                   [groupby_mod.combine_op(pop)] for name, pop in partials}
    out = t.groupby(gb_names, combine_agg).to_numpy()

    def comb(name, pop):
        c = groupby_mod.combine_op(pop)
        return np.asarray(
            out[f"{c.name.lower()}_{pop.name.lower()}_{name}"])

    result = {g: out[g] for g in gb_names}
    for name, op in aggs_req:
        n = comb(name, AggOp.COUNT).astype(np.float64)
        label = f"{op.name.lower()}_{name}"
        if op == AggOp.COUNT:
            result[label] = n.astype(np.int64)
            continue
        empty = n == 0
        with np.errstate(invalid="ignore", divide="ignore"):
            if op == AggOp.SUM:
                v = comb(name, AggOp.SUM)
                if np.issubdtype(src_dtype(name), np.integer):
                    v = np.where(empty, 0, v).astype(np.int64)
            elif op in (AggOp.MIN, AggOp.MAX):
                v = comb(name, op)
            elif op == AggOp.MEAN:
                v = comb(name, AggOp.SUM) / np.maximum(n, 1)
            elif op in (AggOp.VAR, AggOp.STDDEV):
                s, s2 = comb(name, AggOp.SUM), comb(name, AggOp.SUMSQ)
                nn = np.maximum(n, 1)
                v = np.maximum((s2 - s * s / nn) / np.maximum(nn - ddof, 1), 0)
                if op == AggOp.STDDEV:
                    v = np.sqrt(v)
                empty = empty | (n - ddof <= 0)
            else:
                raise CylonError(Code.NotImplemented, f"combine {op.name}")
        if empty.any():
            v = v.astype(object)
            v[empty] = None
        result[label] = v
    return result, len(next(iter(out.values())) if out else [])


# ---------------------------------------------------------------------------
# distributed per-pass execution (each pass sharded over the mesh)
# ---------------------------------------------------------------------------

def _chunked_distributed(arrs_l, names_l, arrs_r, names_r, lon, ron, cfg,
                         joined, pid_l, pid_r, n_passes, counts_l, counts_r,
                         gb_names, aggs_req, final_per_pass, ddof, ctx,
                         mode_used, t_plan0, pass_guard=None):
    """Every key-domain pass sharded over ``ctx``'s mesh through the
    public distributed operators (``cylon_tpu/exec.py:1366``): total
    capacity is passes x the mesh's memory.  Each pass is retried whole
    under ``ctx.collective_retry_policy()`` (no retry across processes:
    one process re-entering a pass would start collectives its peers
    never join); completed frames are the checkpoint, and
    ``stats["retries"]`` counts the extra attempts.  Over a process group
    every process runs every pass (``_agree_on_passes`` checked they
    planned alike): each pass's frame is gathered, so every process
    returns the same frames and counts."""
    from .table import Table

    world = ctx.GetWorldSize()
    shard_cap = pow2ceil(int(max(
        8, -(-int(counts_l.max(initial=0)) // world),
        -(-int(counts_r.max(initial=0)) // world))))
    cap = shard_cap * world
    join_cfg = JoinConfig.of(cfg.join_type, cfg.algorithm, tuple(lon),
                             tuple(ron), cfg.left_prefix, cfg.right_prefix)
    if gb_names is not None:
        pass_agg: Dict[str, list] = {}
        for name, op in (aggs_req if final_per_pass
                         else _partials_for(aggs_req)):
            pass_agg.setdefault(name, []).append(op)

    t_plan = time.perf_counter() - t_plan0
    t_run0 = time.perf_counter()

    def run_pass(p: int):
        resilience.fault_point("pass_dispatch")
        sel_l = pid_l == p
        sel_r = pid_r == p
        lt = Table.from_numpy(names_l, [np.asarray(arrs_l[n])[sel_l]
                                        for n in names_l], ctx=ctx,
                              capacity=cap)
        rt = Table.from_numpy(names_r, [np.asarray(arrs_r[n])[sel_r]
                                        for n in names_r], ctx=ctx,
                              capacity=cap)
        j = lt.distributed_join(rt, join_cfg)
        if gb_names is None:
            return j.to_numpy(), j.row_count
        g = j.groupby(gb_names, pass_agg, ddof=ddof)
        return g.to_numpy(), g.row_count

    frames, total, retries = _mesh_passes(ctx, run_pass, range(n_passes),
                                          pass_guard, notify=True)
    result = _concat_host(frames)
    if gb_names is not None and not final_per_pass:
        result, total = _combine_partials(result, gb_names, aggs_req,
                                          arrs_l, arrs_r, names_l, names_r,
                                          joined, ddof, ctx)
    t_run = time.perf_counter() - t_run0
    stats = {"passes": n_passes, "mode": mode_used, "world": world,
             "shard_cap": shard_cap, "retries": retries,
             "shuffle_pack": plane_mod.pack_enabled(),
             "groups" if gb_names is not None else "rows": total,
             "plan_seconds": t_plan, "run_seconds": t_run,
             "total_seconds": t_plan + t_run}
    return result, stats


def _mesh_passes(ctx, run_pass, order, pass_guard, notify: bool = False):
    """``run_pass(p)`` -> (host frame, rows) for each pass ``p`` of
    ``order``, each retried whole under ``ctx.collective_retry_policy()``
    (transient failures retry the PASS, not the stream); ``pass_guard``
    runs at each pass boundary (completed frames were already fetched,
    nothing in flight is abandoned).  Returns (frames, total rows,
    retries)."""
    policy = ctx.collective_retry_policy()
    order = list(order)
    frames: List[Dict[str, np.ndarray]] = []
    total = retries = 0
    t_run0 = time.perf_counter()
    for i, p in enumerate(order):
        if pass_guard is not None:
            pass_guard()
        (frame, n), attempts = resilience.retry_call(
            lambda p=p: run_pass(p), policy=policy,
            site=f"distributed pass {p}/{len(order)}")
        retries += attempts - 1
        frames.append(frame)
        total += n
        if notify:
            _notify_progress(i + 1, len(order), total,
                             time.perf_counter() - t_run0)
    return frames, total, retries


# ---------------------------------------------------------------------------
# standalone out-of-core operators (no join)
# ---------------------------------------------------------------------------

def chunked_groupby(data, by, agg: Dict, *, passes: int = 4, ddof: int = 0,
                    mode: str = "auto", ctx: Optional[CylonContext] = None,
                    elastic=None, pass_guard=None):
    """Out-of-core group-by over one host frame (``cylon_tpu/exec.py:1460``):
    the key domain is partitioned on the GROUP columns themselves, so every
    pass's group-by is final (a group never spans passes) and the results
    just concatenate.  On one shard a pass that runs out of device memory
    splits the remaining parts (the partition keys are the group keys, so
    refinement never splits a group); on a mesh ``ctx`` each pass is a
    distributed ``Table.groupby``.

    Returns (dict of host columns, stats)."""
    t0 = time.perf_counter()
    _refuse_elastic(elastic)
    names, arrs = _as_host_frame(data)
    by_names = _resolve_keys(names, by, None, "group")
    aggs_req = _normalize_agg(agg, names)
    key_arrs = [np.asarray(arrs[n]) for n in by_names]
    empty = [np.zeros(0, a.dtype) for a in key_arrs]
    pid, _, n_passes, mode_used = _plan_pass_ids(key_arrs, empty, passes, mode)
    by_idx = tuple(names.index(n) for n in by_names)
    aggs_dev = tuple((names.index(n), op) for n, op in aggs_req)
    out_names = list(by_names) + [f"{op.name.lower()}_{n}"
                                  for n, op in aggs_req]
    ctx = _engine_context(ctx)
    world = ctx.GetWorldSize()
    extra: Dict = {}
    if world > 1:
        from .table import Table

        counts = np.bincount(pid, minlength=n_passes)
        shard_cap = pow2ceil(int(max(8, -(-int(counts.max(initial=0))
                                         // world))))
        pass_agg: Dict[str, list] = {}
        for n, op in aggs_req:
            pass_agg.setdefault(n, []).append(op)
        _agree_on_passes(ctx, counts, n_passes, mode_used, shard_cap, names,
                         by_names, [str(a.dtype) for a in key_arrs],
                         sorted(pass_agg))
        t_plan = time.perf_counter() - t0
        t_run0 = time.perf_counter()

        def run_pass(p: int):
            sel = pid == p
            t = Table.from_numpy(names, [np.asarray(arrs[n])[sel]
                                         for n in names], ctx=ctx,
                                 capacity=shard_cap * world)
            g = t.groupby(by_names, pass_agg, ddof=ddof)
            return g.to_numpy(), g.row_count

        frames, total, _ = _mesh_passes(ctx, run_pass, range(n_passes),
                                        pass_guard)
    else:
        device = ctx.devices[0]
        fetch = _fetch_frame(out_names)
        plan = _RefinablePlan(pid, np.zeros(0, np.int32), n_passes,
                              mode_used, key_arrs, [])
        journal = None
        if durable.enabled():
            fp = durable.run_fingerprint(
                "groupby",
                (tuple(by_names),
                 tuple((n, int(o)) for n, o in aggs_req),
                 int(ddof), int(n_passes), mode_used, 1),
                ((names, arrs),))
            journal = durable.open_run(fp, "groupby")

        def make_exec(parts, level):
            pid_lvl, _ = plan.pids(level)
            max_rows, _ = plan.max_part_rows(parts, level)
            build = _SideBuilder(names, arrs, pid_lvl,
                                 pow2ceil(max(8, max_rows)), device)

            def prog(cols, cnt):
                return groupby_mod.hash_groupby(cols, cnt, by_idx, aggs_dev,
                                                ddof)

            warm = build.empty_chunk()
            _block_until_ready(prog(*warm))
            del warm
            return build.chunk, prog, fetch

        t_plan, t_run0, frames, total = _stream_recoverable(
            make_exec, plan, t0, stats=extra, journal=journal,
            pass_guard=pass_guard, device=device)
        _journal_done(journal, extra, frames, total)
    result = _concat_host(frames)
    t_run = time.perf_counter() - t_run0
    stats = {"passes": n_passes, "mode": mode_used, "world": world,
             "groups": total, "plan_seconds": t_plan,
             "run_seconds": t_run, "total_seconds": t_plan + t_run}
    stats.update(extra)
    return result, stats


def chunked_unique(data, columns=None, *, passes: int = 4,
                   mode: str = "auto", ctx: Optional[CylonContext] = None):
    """Out-of-core distinct rows over ``columns`` (default: all): a
    ``chunked_groupby`` with no aggregates, whose key-domain partition
    makes every pass's distinct set disjoint from the others'
    (``cylon_tpu/exec.py:1748``).

    Returns (dict of host columns, stats with "rows")."""
    if columns is None:
        # names only: chunked_groupby does the one host conversion
        if isinstance(data, dict):
            columns = [str(k) for k in data]
        elif hasattr(data, "names"):
            columns = list(data.names)
        else:
            columns = [str(c) for c in data.columns]
    result, stats = chunked_groupby(data, columns, {}, passes=passes,
                                    mode=mode, ctx=ctx)
    stats["rows"] = stats.pop("groups")
    return result, stats


def chunked_sort(data, by, *, ascending=True, nulls_first: bool = True,
                 passes: int = 4, ctx: Optional[CylonContext] = None,
                 pass_guard=None):
    """Out-of-core GLOBAL sort of one host frame (``cylon_tpu/exec.py:1771``):
    range-partition on the first sort column's order-preserving prefix,
    sort each pass on the device (one shard) or with ``distributed_sort``
    (a mesh ``ctx``), and emit the passes in key order, reversed for a
    descending first key.  Null first-key rows go to the pass emitted
    first (``nulls_first``) or last.  Passes are not refined on OOM: a
    hash subdivision would scramble the emit order.

    Returns (dict of host columns in global sort order, stats)."""
    from .config import SortOptions

    t0 = time.perf_counter()
    names, arrs = _as_host_frame(data)
    by_names = _resolve_keys(names, by, None, "sort")
    if isinstance(ascending, bool):
        ascending = [ascending] * len(by_names)
    if len(ascending) != len(by_names):
        raise CylonError(Code.Invalid,
                         f"ascending length {len(ascending)} != "
                         f"{len(by_names)} sort columns")
    key0 = np.asarray(arrs[by_names[0]])
    empty = np.zeros(0, key0.dtype)
    pid, _, n_passes, _ = _plan_pass_ids([key0], [empty], passes, "range")
    emit_order = (list(range(n_passes)) if ascending[0]
                  else list(range(n_passes - 1, -1, -1)))
    nulls = _null_mask(key0)
    if nulls is not None and nulls.any():
        target = emit_order[0] if nulls_first else emit_order[-1]
        pid = np.where(nulls, target, pid)
    counts = np.bincount(pid, minlength=n_passes)
    cap = pow2ceil(int(max(8, counts.max(initial=0))))
    by_idx = tuple(names.index(n) for n in by_names)
    asc = tuple(bool(a) for a in ascending)
    ctx = _engine_context(ctx)
    world = ctx.GetWorldSize()
    extra: Dict = {}
    if world > 1:
        from .table import Table

        _agree_on_passes(ctx, counts, n_passes, emit_order, cap, names,
                         by_names, asc, nulls_first)
        t_plan = time.perf_counter() - t0
        t_run0 = time.perf_counter()

        def run_pass(p: int):
            sel = pid == p
            t = Table.from_numpy(names, [np.asarray(arrs[n])[sel]
                                         for n in names], ctx=ctx,
                                 capacity=cap)
            s = t.distributed_sort(
                by_names, options=SortOptions(nulls_first=nulls_first),
                ascending=list(asc))
            return s.to_numpy(), s.row_count

        frames, total, _ = _mesh_passes(ctx, run_pass, emit_order,
                                        pass_guard)
    else:
        from .ops import sort as sort_mod

        build = _SideBuilder(names, arrs, pid, cap, ctx.devices[0])

        def prog(cols, cnt):
            return sort_mod.sort_rows(cols, cnt, by_idx, asc, nulls_first)

        journal = None
        if durable.enabled():
            # positional passes (no refinement), keyed by emit position
            fp = durable.run_fingerprint(
                "sort",
                (tuple(by_names), tuple(asc), bool(nulls_first),
                 int(n_passes), 1),
                ((names, arrs),))
            journal = durable.open_run(fp, "sort")
        t_plan, t_run0, frames, total = _run_passes(
            prog, build.empty_chunk, lambda p: build.chunk(emit_order[p]),
            n_passes, _fetch_frame(names), t0, stats=extra,
            journal=journal, pass_guard=pass_guard)
        _journal_done(journal, extra, frames, total)
    result = _concat_host(frames)
    t_run = time.perf_counter() - t_run0
    stats = {"passes": n_passes, "mode": "range", "world": world,
             "rows": total, "plan_seconds": t_plan, "run_seconds": t_run,
             "total_seconds": t_plan + t_run}
    for k in ("passes_skipped", "quarantined", "retries", "parts_run"):
        if k in extra:
            stats[k] = extra[k]
    return result, stats


def _write_parquet(frame: Dict[str, np.ndarray], path: str) -> None:
    """One host frame as a parquet file (pyarrow, imported here only)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({n: pa.array(a) for n, a in frame.items()}),
                   path)


def chunked_repartition(data, keys, world: int, *, passes: int = 4,
                        out_dir: Optional[str] = None,
                        ctx: Optional[CylonContext] = None):
    """Out-of-core hash repartition of one host frame into ``world`` hash
    shards, streamed through the device in ``passes`` passes of contiguous
    row blocks (``cylon_tpu/exec.py:1570``; BASELINE config 3, the 1B-row
    hash shuffle).  Each pass on one shard runs the distributed shuffle's
    local half: murmur3 targets (``partition.hash_targets``), the stable
    grouping by target and its counts, so a target's per-pass slices,
    concatenated, are exactly the shard the mesh shuffle would deliver.
    With a mesh ``ctx`` each pass runs the real shuffle instead, and
    ``world`` must equal the mesh's.

    With ``out_dir``, each (target, pass) slice lands in
    ``{out_dir}/shard_{t}/part_{p:04d}.parquet`` (stale ``part_*.parquet``
    files under ``shard_*`` are removed first) and only counts are kept;
    otherwise per-target host frames are returned.

    Over a process group target ``t`` is global shard ``t``, so each
    process holds only its own shards' targets (``ctx.shard_ids``): its
    ``result[t]`` is None for a target another process holds, and with
    ``out_dir`` it writes only its own ``shard_{t}`` directories (process
    0 removes the stale parts before any process writes).
    ``stats["per_target"]`` and ``stats["rows"]`` are global, summed over
    the processes, and equal on every process.

    Returns (list of ``world`` per-target host frames, or None with
    ``out_dir``; stats)."""
    t0 = time.perf_counter()
    names, arrs = _as_host_frame(data)
    key_names = _resolve_keys(names, keys, None, "partition")
    key_idx = tuple(names.index(n) for n in key_names)
    if world < 1:
        raise CylonError(Code.Invalid, f"world must be >= 1, got {world}")
    n_rows = int(np.asarray(arrs[names[0]]).shape[0]) if names else 0
    n_passes = max(1, min(passes, max(1, n_rows)))
    block = -(-n_rows // n_passes)
    cap = pow2ceil(max(8, block))
    ctx = _engine_context(ctx)
    wctx = ctx.GetWorldSize()
    if wctx > 1 and world != wctx:
        raise CylonError(Code.Invalid,
                         f"world {world} != distributed context world "
                         f"{wctx}: with ctx the mesh defines the shard "
                         f"count")
    mine = ctx.shard_ids if wctx > 1 else list(range(world))
    if wctx > 1:
        _agree_on_passes(ctx, n_rows, n_passes, block, cap, world, names,
                         key_names, out_dir is not None)
    if out_dir is not None:
        import glob

        # a reused out_dir must not mix this run's parts with an earlier
        # run's: clear this layout only, never foreign files
        if ctx.GetRank() == 0:
            for stale in glob.glob(os.path.join(out_dir, "shard_*",
                                                "part_*.parquet")):
                os.remove(stale)
        if ctx.group is not None:
            ctx.Barrier()  # no process writes before the stale parts go
        for t in mine:
            os.makedirs(os.path.join(out_dir, f"shard_{t}"), exist_ok=True)

    acc: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(world)]
    per_target = np.zeros(world, np.int64)

    def store(t: int, p: int, frame: Dict[str, np.ndarray], n: int) -> None:
        per_target[t] += n
        if out_dir is not None:
            _write_parquet(frame, os.path.join(out_dir, f"shard_{t}",
                                               f"part_{p:04d}.parquet"))
        else:
            acc[t].append(frame)

    def rows(p: int):
        lo, hi = p * block, min((p + 1) * block, n_rows)
        return [np.asarray(arrs[n])[lo:hi] for n in names]

    total = 0
    extra: Dict = {}
    if wctx > 1:
        from .table import Table

        t_plan = time.perf_counter() - t0
        t_run0 = time.perf_counter()
        policy = ctx.collective_retry_policy()
        for p in range(n_passes):
            def run_pass(p=p):
                t = Table.from_numpy(names, rows(p), ctx=ctx, capacity=cap)
                return t.shuffle(key_names).shard_frames()

            local, _ = resilience.retry_call(
                run_pass, policy=policy,
                site=f"distributed pass {p}/{n_passes}")
            for sid, frame, n in local:
                store(sid, p, frame, n)
        extra["shuffle_pack"] = plane_mod.pack_enabled()
        if ctx.group is not None:  # every process's targets, summed
            from .parallel import collectives

            per_target[:] = collectives.process_allgather(
                per_target[None, :], ctx.group).sum(axis=0)
        total = int(per_target.sum())
    else:
        from .parallel import partition as partition_mod
        from .parallel import shuffle as shuffle_mod

        device = ctx.devices[0]
        widths = {n: _str_width(a) for n, a in arrs.items()
                  if np.asarray(a).dtype.kind in "USO"}

        def slice_chunk(p: int):
            host = rows(p)
            cols = tuple(colmod.from_numpy(
                a, capacity=cap,
                string_width=widths.get(n, colmod.DEFAULT_STRING_WIDTH),
                device=device) for n, a in zip(names, host))
            count = len(host[0]) if host else 0
            return cols, torch.tensor(count, dtype=torch.int32,
                                      device=device)

        def prog(cols, cnt):
            t = partition_mod.hash_targets(cols, cnt, key_idx, world)
            perm_t = shuffle_mod._perm_by_target(t, world)
            counts = shuffle_mod.target_counts(t, world)
            return tuple(c.take(perm_t) for c in cols), counts

        def fetch_and_store(out, p: int) -> int:
            grouped, counts = out
            cnts = counts.cpu().numpy().astype(np.int64)
            n = int(cnts.sum())
            frame = {name: colmod.to_numpy(c, n)
                     for name, c in zip(names, grouped)}
            offs = np.concatenate([[0], np.cumsum(cnts)])
            for t in range(world):
                store(t, p, {name: a[offs[t]:offs[t + 1]]
                             for name, a in frame.items()},
                      int(cnts[t]))
            return n

        warm = prog(*slice_chunk(n_passes))    # an empty block
        _block_until_ready(warm)
        del warm
        t_plan = time.perf_counter() - t0
        prefetch = config.knob("CYLON_TPU_PREFETCH")
        t_run0 = time.perf_counter()
        nxt = slice_chunk(0) if prefetch else None
        for p in range(n_passes):
            cur = nxt if prefetch else slice_chunk(p)
            fut = prog(*cur)                   # async dispatch
            nxt = (slice_chunk(p + 1) if prefetch and p + 1 < n_passes
                   else None)
            total += fetch_and_store(fut, p)   # blocks
            del cur, fut
        del nxt
    t_run = time.perf_counter() - t_run0
    result = (None if out_dir is not None
              else [_concat_host(acc[t]) if t in mine else None
                    for t in range(world)])
    stats = {"passes": n_passes, "world": world, "rows": total,
             "per_target": per_target.tolist(), **extra,
             "plan_seconds": t_plan, "run_seconds": t_run,
             "total_seconds": t_plan + t_run}
    return result, stats


# ---------------------------------------------------------------------------
# the benchmark's fixed-schema entry points
# ---------------------------------------------------------------------------

def key_range_bounds(lo: int, hi: int, passes: int) -> List[Tuple[int, int]]:
    """Split [lo, hi) into ``passes`` near-equal [start, stop) intervals."""
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    span = hi - lo
    edges = [lo + (span * p) // passes for p in range(passes)] + [hi]
    return [(edges[p], edges[p + 1]) for p in range(passes)]


def chunked_join_groupby(lk: np.ndarray, lv: np.ndarray,
                         rk: np.ndarray, rv: np.ndarray,
                         passes: int, algo: str = "sort",
                         aggs: Tuple[Tuple[int, AggOp], ...] = (
                             (1, AggOp.SUM), (3, AggOp.MEAN)),
                         ctx: Optional[CylonContext] = None):
    """INNER join on int keys + group-by over key, in ``passes`` key-domain
    passes: the benchmark's fixed (k,v)x(k,v) shape over the general
    engine, on ``ctx``'s device (default: the CUDA card).  Returns
    ({"key", "agg0", ...}, stats)."""
    joined = ["l_k", "a", "r_k", "b"]
    agg: Dict[str, list] = {}
    labels = []
    for idx, op in aggs:
        name = joined[idx]
        agg.setdefault(name, []).append(op)
        labels.append(f"{op.name.lower()}_{name}")
    result, stats = chunked_join_groupby_tables(
        {"k": lk, "a": lv}, {"k": rk, "b": rv}, on="k", how="inner",
        group_by="l_k", agg=agg, passes=passes, algo=algo, mode="auto",
        ctx=ctx)
    out = {"key": result["l_k"]}
    for i, label in enumerate(labels):
        out[f"agg{i}"] = result[label]
    return out, stats


def chunked_distributed_join_groupby(lk: np.ndarray, lv: np.ndarray,
                                     rk: np.ndarray, rv: np.ndarray,
                                     passes: int, ctx: CylonContext,
                                     agg: Optional[Dict] = None):
    """The benchmark's (k,v)x(k,v) shape over a mesh ``ctx``: every
    key-domain pass sharded over the mesh (``cylon_tpu/exec.py:1908``).
    Returns ({"l_k", "sum_a", "mean_b", ...}, stats)."""
    if agg is None:
        agg = {"a": ["sum"], "b": ["mean"]}
    return chunked_join_groupby_tables(
        {"k": lk, "a": lv}, {"k": rk, "b": rv}, on="k", how="inner",
        group_by="l_k", agg=agg, passes=passes, ctx=ctx, mode="auto")
