"""A table of columns split into shards over an in-process mesh.

The port of the parts of ``cylon_tpu/table.py:55 Table`` that the
distributed rung runs.  The reference holds one global array per buffer,
sharded over its mesh, and ``int32[num_shards]`` row counts; this Table
holds one tuple of Columns per shard, each on its shard's device
(``ctx.devices[i]``), and one 0-d int32 row count per shard beside it.
Every shard of a table has the same capacity.

Ported: ``from_numpy`` (contiguous chunks, ``_shard_plan``), ``to_numpy``
(live rows gathered in shard order), ``project``,
``distributed_join`` (shuffle both sides, then ``_local_join``'s exact
two-pass sizing), ``groupby`` (``groupby_type="hash"``; local when one
shard), ``shuffle`` and ``hash_partition``.  The reference's adaptive
join-capacity cache and out-of-core fallbacks are not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import column as column_mod
from .column import Column
from .config import JoinConfig
from .context import CylonContext
from .ops import groupby as groupby_mod
from .ops import join as join_mod
from .ops.groupby import AggOp
from .parallel import ops as par_ops
from .status import Code, CylonError


@dataclass
class Table:
    """shards: per shard, its columns; counts: per shard, its live-row
    count (0-d int32 on the shard's device); names, ctx: metadata."""

    shards: Tuple[Tuple[Column, ...], ...]
    counts: Tuple[torch.Tensor, ...]
    names: Tuple[str, ...]
    ctx: CylonContext

    # -- shape / metadata ---------------------------------------------------
    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_capacity(self) -> int:
        return self.shards[0][0].capacity if self.names else 0

    @property
    def row_counts(self) -> np.ndarray:
        """Per-shard live-row counts on the host (synchronises)."""
        dev = self.counts[0].device
        return torch.stack([c.to(dev) for c in self.counts]).cpu().numpy()

    @property
    def row_count(self) -> int:
        return int(self.row_counts.sum())

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.dtype}"
                         for n, c in zip(self.names, self.shards[0]))
        return (f"Table[{self.row_count} rows x {len(self.names)} cols | "
                f"shards={self.num_shards} cap={self.shard_capacity}]({cols})")

    def _like(self, shards, counts, names=None) -> "Table":
        """A table of this one's context; ``counts`` may be host ints."""
        counts = tuple(c if isinstance(c, torch.Tensor) else
                       torch.tensor(int(c), dtype=torch.int32, device=dev)
                       for c, dev in zip(counts, self.ctx.devices))
        return Table(tuple(tuple(s) for s in shards), counts,
                     tuple(self.names if names is None else names), self.ctx)

    # -- column references --------------------------------------------------
    def _resolve(self, ref) -> int:
        if isinstance(ref, (int, np.integer)):
            i = int(ref)
            if not 0 <= i < len(self.names):
                raise CylonError(Code.IndexError,
                                 f"column index {i} out of range")
            return i
        try:
            return self.names.index(ref)
        except ValueError:
            raise CylonError(Code.KeyError, f"no column named {ref!r}")

    def _resolve_many(self, refs) -> Tuple[int, ...]:
        if isinstance(refs, (int, np.integer, str)):
            refs = [refs]
        return tuple(self._resolve(r) for r in refs)

    # -- host boundary ------------------------------------------------------
    @staticmethod
    def from_numpy(names: Sequence[str], arrays: Sequence[np.ndarray],
                   ctx: Optional[CylonContext] = None) -> "Table":
        """Rows split into contiguous chunks of ``ceil(n/world)``, chunk
        ``i`` on shard ``i`` at shard capacity ``max(8, chunk)``, as
        ``cylon_tpu/table.py:1640 _shard_plan``."""
        ctx = ctx or CylonContext.Init()
        arrays = [np.asarray(a) for a in arrays]
        n = len(arrays[0]) if arrays else 0
        for name, a in zip(names, arrays):
            if len(a) != n:
                raise CylonError(Code.Invalid,
                                 f"column {name} length {len(a)} != {n}")
        world = ctx.GetWorldSize()
        chunk, counts, shard_cap = _shard_plan(n, world)
        shards = [tuple(column_mod.from_numpy(a[s * chunk:s * chunk
                                                 + counts[s]],
                                              capacity=shard_cap, device=dev)
                        for a in arrays)
                  for s, dev in enumerate(ctx.devices)]
        counts_t = tuple(torch.tensor(c, dtype=torch.int32, device=dev)
                         for c, dev in zip(counts, ctx.devices))
        return Table(tuple(shards), counts_t, tuple(names), ctx)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Live rows of every shard, in shard order; nulls become None in
        an object array (``column.to_numpy``)."""
        counts = self.row_counts
        out = {}
        for j, name in enumerate(self.names):
            data = torch.cat([s[j].data[:int(n)].cpu()
                              for s, n in zip(self.shards, counts)])
            valid = torch.cat([s[j].validity[:int(n)].cpu()
                               for s, n in zip(self.shards, counts)])
            col = Column(data, valid, None, self.shards[0][j].dtype)
            out[name] = column_mod.to_numpy(col, int(counts.sum()))
        return out

    # -- column subsets -----------------------------------------------------
    def project(self, refs) -> "Table":
        idx = self._resolve_many(refs)
        return self._like([tuple(s[i] for i in idx) for s in self.shards],
                          self.counts, tuple(self.names[i] for i in idx))

    # -- distributed operators ----------------------------------------------
    def distributed_join(self, other: "Table",
                         config: Optional[JoinConfig] = None, *, on=None,
                         left_on=None, right_on=None, how="inner",
                         algorithm="sort") -> "Table":
        """Global join: shuffle both tables on the key columns, then join
        shard by shard (reference: DistributedJoin, table.cpp:459-489)."""
        cfg = _join_config(self, other, config, on, left_on, right_on, how,
                           algorithm)
        if self.num_shards == 1:
            return _local_join(self, other, cfg)
        return _local_join(par_ops.shuffle(self, cfg.left_on),
                           par_ops.shuffle(other, cfg.right_on), cfg)

    def groupby(self, by, agg: Dict, ddof: int = 0,
                groupby_type: str = "hash") -> "Table":
        """Group-by: the local hash group-by for one shard, else the
        two-phase distributed one (partial aggregate, shuffle on the keys,
        combine; reference: groupby/groupby.cpp:23-73)."""
        if groupby_type == "pipeline":
            raise CylonError(Code.NotImplemented,
                             "groupby_type='pipeline' is not ported yet")
        if groupby_type != "hash":
            raise CylonError(Code.Invalid,
                             f"bad groupby_type {groupby_type!r}")
        by_idx = self._resolve_many(by)
        aggs: List[Tuple[int, AggOp]] = []
        for ref, ops in agg.items():
            ci = self._resolve(ref)
            for op in ([ops] if isinstance(ops, (str, AggOp)) else ops):
                aggs.append((ci, AggOp.of(op)))
        if self.num_shards == 1:
            return _local_groupby(self, by_idx, tuple(aggs), ddof)
        return par_ops.distributed_groupby(self, by_idx, tuple(aggs), ddof)

    def shuffle(self, refs) -> "Table":
        """Hash-repartition rows over the mesh (reference: Shuffle,
        table.cpp:951-964)."""
        if self.num_shards == 1:
            return self
        return par_ops.shuffle(self, self._resolve_many(refs))

    def hash_partition(self, refs, num_partitions: int) -> Dict[int, "Table"]:
        """Split into ``num_partitions`` tables by key hash, shard-locally
        (reference: HashPartition, table.cpp:358-375)."""
        if num_partitions < 1:
            raise CylonError(Code.Invalid, "num_partitions must be >= 1, got "
                             f"{num_partitions}")
        return par_ops.hash_partition(self, self._resolve_many(refs),
                                      num_partitions)


# ---------------------------------------------------------------------------
# internals
# ---------------------------------------------------------------------------

def _shard_plan(n: int, world: int):
    chunk = math.ceil(n / world) if n else 0
    counts = [max(0, min(chunk, n - s * chunk)) for s in range(world)]
    return chunk, counts, max(8, chunk)


def cap_round(n: int) -> int:
    """Round a row count up to a 3-bit-mantissa capacity (at most 8 sizes
    per octave; ``cylon_tpu/table.py:1238 _cap_round``)."""
    if n <= 16:
        return 16
    g = 1 << ((n - 1).bit_length() - 3)
    return -(-n // g) * g


def _join_config(left: Table, right: Table, config, on, left_on, right_on,
                 how, algorithm) -> JoinConfig:
    if config is None:
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise CylonError(Code.Invalid,
                             "join requires on= or left_on=/right_on=")
        config = JoinConfig.of(how, algorithm, left_on, right_on)
    cfg = JoinConfig(config.join_type, config.algorithm,
                     left._resolve_many(config.left_on),
                     right._resolve_many(config.right_on),
                     config.left_prefix, config.right_prefix)
    if len(cfg.left_on) != len(cfg.right_on):
        raise CylonError(Code.Invalid, "left_on/right_on length mismatch")
    for li, ri in zip(cfg.left_on, cfg.right_on):
        lt, rt = left.shards[0][li].dtype, right.shards[0][ri].dtype
        if lt != rt:
            raise CylonError(Code.Invalid,
                             f"join key type mismatch: {left.names[li]}:{lt} "
                             f"vs {right.names[ri]}:{rt} (cast the keys to a "
                             "common type)")
    return cfg


def _join_output_names(left: Table, right: Table,
                       cfg: JoinConfig) -> Tuple[str, ...]:
    """left names ++ right names, prefixing collisions."""
    both = set(left.names) & set(right.names)
    return tuple([cfg.left_prefix + n if n in both else n
                  for n in left.names]
                 + [cfg.right_prefix + n if n in both else n
                    for n in right.names])


def _local_join(left: Table, right: Table, cfg: JoinConfig) -> Table:
    """Shard-by-shard join with the exact two-pass sizing: every shard's
    output count, ``cap_round`` of the largest, one gather per shard at
    that common capacity."""
    pairs = list(zip(left.shards, left.counts, right.shards, right.counts))
    counts = [join_mod.join_row_count(a, ca, b, cb, cfg.left_on,
                                      cfg.right_on, cfg.join_type,
                                      cfg.algorithm)
              for a, ca, b, cb in pairs]
    out_cap = cap_round(max(1, max(int(c) for c in counts)))
    shards, out_counts = [], []
    for a, ca, b, cb in pairs:
        cols, m = join_mod.join_gather(a, ca, b, cb, cfg.left_on,
                                       cfg.right_on, cfg.join_type, out_cap,
                                       cfg.algorithm)
        shards.append(cols)
        out_counts.append(m)
    return left._like(shards, out_counts,
                      _join_output_names(left, right, cfg))


def _local_groupby(t: Table, by_idx: Tuple[int, ...],
                   aggs: Tuple[Tuple[int, AggOp], ...], ddof: int) -> Table:
    shards, counts = [], []
    for cols, n in zip(t.shards, t.counts):
        out, m = groupby_mod.hash_groupby(cols, n, by_idx, aggs, ddof)
        shards.append(out)
        counts.append(m)
    return t._like(shards, counts, _groupby_output_names(t, by_idx, aggs))


def _groupby_output_names(t: Table, by_idx, aggs) -> Tuple[str, ...]:
    return tuple([t.names[i] for i in by_idx]
                 + [f"{AggOp(op).name.lower()}_{t.names[ci]}"
                    for ci, op in aggs])
