"""Hash join: open-addressing build and probe.

The port of ``cylon_tpu/ops/hash_join.py`` (reference: ``do_hash_join``
cpp/src/cylon/join/join.cpp:448-513, ``HashJoinKernel``
arrow/arrow_hash_kernels.hpp:33-215):

- the table is an ``int32[slots]`` array of build-row ids, ``slots`` the
  power of two at or above twice the build capacity, probed with
  triangular-number offsets ``p(p+1)/2``, which visit every slot of a
  power-of-two table once per cycle;
- the build is a loop of claim rounds: every unplaced build row tries to
  claim its probe slot with one scatter-min (a contended empty slot goes
  to the lowest row id, so the table is deterministic), a row whose slot
  holds an equal key chains to that owner, any other row steps on;
- the probe walks each probe row's slot sequence until an empty slot (no
  match) or an owner with an equal key (the match);
- multiplicity reuses the sort join's histogram expansion: build rows
  sorted by owner make each probe row's matches one contiguous range.

Key equality is over the packed key operands the sort join orders by
(``keys.pack_operands(keys.column_operands(...))``), so nulls equal nulls
and strings compare bytewise in both algorithms.  The row hash is
``hashing.hash_columns``, which folds float keys (-0.0 as +0.0, one NaN)
before hashing, so keys that compare equal always meet; the JAX package
hashes raw float bits and misses the match of ``0.0`` with ``-0.0``.

Every round reads the loop state on the host (the reference's
``~all(done) & it < slots + 2``): a round works only on the rows still
unsettled, which the reference masks instead of dropping, and dropping
the settled rows from the row list and from its probe counts is two
device syncs (``sync.hash_build_round`` / ``sync.hash_probe_round``);
listing the live rows before the first round is one more each
(``sync.hash_build_rows`` / ``sync.hash_probe_rows``).  Settled rows
never change, so the table, the owners and the matches are the
reference's.  ``ROUNDS`` counts the build and probe rounds.

No Pallas kernel stands behind the reference's loops (they are
``lax.while_loop``s of XLA ops), so this is plain PyTorch on either
device; the build side's offsets go through ``scan.scan_1d`` in narrow
mode, the CUDA scan kernel on the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import precision
from ..column import Column
from ..config import JoinType
from ..obs import spans as obs_spans
from ..utils import pow2ceil
from . import common, hashing, keys, scan

# empty-slot sentinel, and the sort key that sends unmatched rows last
_EMPTY = (1 << 31) - 1

ROUNDS = {"build": 0, "probe": 0}


def reset_rounds() -> None:
    for k in ROUNDS:
        ROUNDS[k] = 0


def _step_offset(p: torch.Tensor) -> torch.Tensor:
    """Triangular probe offset ``p(p+1)/2`` in int64, shared by build and
    probe (both must walk the same slot sequence).  The reference takes it
    in uint32, ``(p(p+1) mod 2^32) >> 1``; since ``p(p+1)`` is even, that
    and ``p(p+1)/2`` agree in their low 31 bits, and a table of at most
    2^31 slots reads no more, so the masked slot is the reference's bit
    for bit."""
    p = p.to(torch.int64)
    return (p * (p + 1)) >> 1


def _row_eq(ops: Sequence[torch.Tensor], i_idx: torch.Tensor,
            j_idx: torch.Tensor) -> torch.Tensor:
    """Row equality over packed key operands: rows ``i_idx`` against rows
    ``j_idx`` of the concatenated (left ++ right) operands."""
    eq = torch.ones(i_idx.shape, dtype=torch.bool, device=i_idx.device)
    for o in ops:
        eq &= o[i_idx] == o[j_idx]
    return eq


def _combined_key_ops(cols_l, cols_r, left_on, right_on):
    """Packed operands of the cap_l + cap_r key rows, comparable across
    the tables, and the composite row hash of the concatenation (int64
    holding the uint32 value)."""
    combined = []
    ops = []
    for ia, ib in zip(left_on, right_on):
        c = common.concat_columns(cols_l[ia], cols_r[ib])
        combined.append(c)
        ops.extend(keys.column_operands(c))
    return keys.pack_operands(ops), hashing.hash_columns(combined)


def _slot(h: torch.Tensor, p: torch.Tensor, slots: int) -> torch.Tensor:
    return (h + _step_offset(p)) & (slots - 1)


def _build(h_r: torch.Tensor, live_r: torch.Tensor, ops, cap_l: int,
           slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert the live build rows.  Returns (table, owner[cap_r]): each
    build row's chain head, itself or the first-inserted row with an
    equal key (``_EMPTY`` for dead rows)."""
    cap_r = h_r.shape[0]
    dev = h_r.device
    tab = torch.full((slots,), _EMPTY, dtype=torch.int32, device=dev)
    owner = torch.full((cap_r,), _EMPTY, dtype=torch.int32, device=dev)
    # unplaced rows, ascending
    act = obs_spans.host_select(live_r, "hash_build_rows")
    p = torch.zeros(act.shape, dtype=torch.int64, device=dev)
    it = 0
    while act.numel() and it < slots + 2:
        rid = act.to(torch.int32)
        cand = _slot(h_r[act], p, slots)
        occ = tab[cand]
        empty = occ == _EMPTY
        # claim round: a row that found its slot occupied scatters the
        # neutral _EMPTY there, so only the claimants' minimum lands
        tab.scatter_reduce_(0, cand, torch.where(
            empty, rid, torch.full((), _EMPTY, dtype=torch.int32,
                                   device=dev)), "amin")
        won = empty & (tab[cand] == rid)
        occ_l = occ.clamp(0, cap_r - 1).to(torch.int64)
        dup = ~empty & _row_eq(ops, cap_l + act, cap_l + occ_l)
        owner[act] = torch.where(won, rid, torch.where(dup, occ, owner[act]))
        step = ~empty & ~dup
        left = ~(won | dup)
        act, p = (obs_spans.host_select(left, "hash_build_round", act),
                  obs_spans.host_select(left, "hash_build_round",
                                        p + step.to(torch.int64)))
        it += 1
        ROUNDS["build"] += 1
    return tab, owner


def _probe(h_l: torch.Tensor, live_l: torch.Tensor, tab: torch.Tensor, ops,
           cap_r: int, slots: int) -> torch.Tensor:
    """Walk each live probe row's slot sequence; returns rep[cap_l], the
    matching chain head's build row id, or -1."""
    cap_l = h_l.shape[0]
    dev = h_l.device
    rep = torch.full((cap_l,), -1, dtype=torch.int32, device=dev)
    act = obs_spans.host_select(live_l, "hash_probe_rows")
    p = torch.zeros(act.shape, dtype=torch.int64, device=dev)
    it = 0
    while act.numel() and it < slots + 2:
        occ = tab[_slot(h_l[act], p, slots)]
        empty = occ == _EMPTY
        occ_l = occ.clamp(0, cap_r - 1).to(torch.int64)
        hit = ~empty & _row_eq(ops, act, cap_l + occ_l)
        rep[act] = torch.where(hit, occ, rep[act])
        left = ~empty & ~hit
        act, p = (obs_spans.host_select(left, "hash_probe_round", act),
                  obs_spans.host_select(left, "hash_probe_round", p) + 1)
        it += 1
        ROUNDS["probe"] += 1
    return rep


def match_ranges_hash(cols_l: Sequence[Column], count_l,
                      cols_r: Sequence[Column], count_r,
                      left_on: Tuple[int, ...], right_on: Tuple[int, ...],
                      join_type: JoinType):
    """The hash algorithm's match ranges, in the sort join's contract:
    (lo, matches, perm_r, live_l, unmatched_r), with ``perm_r`` the build
    rows ordered by chain head (the order ``lo`` indexes)."""
    cap_l = cols_l[0].capacity
    cap_r = cols_r[0].capacity
    dev = cols_l[0].device
    slots = pow2ceil(2 * cap_r)

    ops, h = _combined_key_ops(cols_l, cols_r, left_on, right_on)
    h_l, h_r = h[:cap_l], h[cap_l:]
    live_l = torch.arange(cap_l, dtype=torch.int32, device=dev) < count_l
    live_r = torch.arange(cap_r, dtype=torch.int32, device=dev) < count_r

    tab, owner = _build(h_r, live_r, ops, cap_l, slots)
    rep = _probe(h_l, live_l, tab, ops, cap_r, slots)
    del tab

    # build rows per chain head -> contiguous ranges in owner order
    n_gid = cap_r + 1
    cap_gid = torch.full((), cap_r, dtype=torch.int32, device=dev)
    gid_r = torch.where(live_r, owner.clamp(0, cap_r - 1), cap_gid).long()
    counts_r = torch.zeros(n_gid, dtype=torch.int32, device=dev)
    counts_r.index_add_(0, gid_r, live_r.to(torch.int32))
    if precision.narrow(dev):  # the scan kernel on the card
        csum_r = scan.scan_1d(counts_r, "sum")
    else:
        csum_r = torch.cumsum(counts_r, 0, dtype=torch.int32)
    rstart = csum_r - counts_r

    found = live_l & (rep >= 0)
    gid_l = torch.where(found, rep, cap_gid).long()
    lo = rstart[gid_l]
    matches = torch.where(found, counts_r[gid_l],
                          torch.zeros((), dtype=torch.int32, device=dev))

    rkey = torch.where(live_r, gid_r.to(torch.int32),
                       torch.full((), _EMPTY, dtype=torch.int32, device=dev))
    perm_r = torch.sort(rkey, stable=True).indices.to(torch.int32)

    if join_type in (JoinType.RIGHT, JoinType.FULL_OUTER):
        counts_l = torch.zeros(n_gid, dtype=torch.int32, device=dev)
        counts_l.index_add_(0, gid_l, live_l.to(torch.int32))
        unmatched_r = live_r & (counts_l[gid_r] == 0)
    else:
        unmatched_r = torch.zeros(cap_r, dtype=torch.bool, device=dev)
    return lo, matches, perm_r, live_l, unmatched_r
