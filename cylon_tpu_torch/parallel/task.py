"""Task-multiplexed all-to-all: many logical tables, one exchange.

The port of ``cylon_tpu/parallel/task.py`` (``LogicalTaskPlan:26``,
``task_shuffle:55``, ``_task_predicate:96``, ``_plan_shuffle:107``), the
counterpart of Cylon's ArrowTaskAllToAll
(cpp/src/cylon/arrow/arrow_task_all_to_all.h:9-59): a ``LogicalTaskPlan``
maps logical task ids onto workers, every logical table's rows are tagged
with their task id and concatenated, and all of them move in ONE exchange
whose targets come from the plan's task -> worker lookup table instead of
a key hash.

The reference's exchange is its bucketed shuffle (``world * world *
bucket`` rows); the port's is the exact-traffic shuffle
(``shuffle.shuffle_shard_ragged``, packed or per buffer by
``plane.pack_enabled()``), so its ``shuffle.bytes_sent`` counts the rows
that exist.  The exchange retries under ``ctx.collective_retry_policy()``
like every exchange (site ``shuffle``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import resilience
from ..obs import spans as obs_spans
from ..ops import compact
from ..status import Code, CylonError

TASK_COL = "__task__"


class LogicalTaskPlan:
    """task id -> worker (shard) assignment (reference:
    arrow_task_all_to_all.h:9-24 LogicalTaskPlan)."""

    def __init__(self, task_to_worker: Dict[int, int], world_size: int):
        for task, worker in task_to_worker.items():
            if not 0 <= worker < world_size:
                raise CylonError(
                    Code.Invalid,
                    f"task {task} assigned to worker {worker} outside world "
                    f"of {world_size}")
        self._map = dict(task_to_worker)
        self.world_size = world_size

    def worker_for(self, task: int) -> int:
        return self._map[task]

    def tasks_of(self, worker: int) -> List[int]:
        return sorted(t for t, w in self._map.items() if w == worker)

    @property
    def tasks(self) -> List[int]:
        return sorted(self._map)

    def __repr__(self) -> str:
        return f"LogicalTaskPlan({self._map}, world={self.world_size})"


def task_shuffle(tables: Sequence, task_ids: Sequence[int],
                 plan: LogicalTaskPlan) -> List:
    """Move each logical table's rows to its task's worker, all tasks in
    one exchange.  ``tables`` share a schema.  Returns one table per input
    task; output i's rows lie entirely on shard ``plan.worker_for(
    task_ids[i])`` (every other shard holds none of them)."""
    if len(tables) != len(task_ids):
        raise CylonError(Code.Invalid, "one task id per table required")
    unplanned = sorted(set(task_ids) - set(plan.tasks))
    if unplanned:
        raise CylonError(Code.Invalid,
                         f"task ids not in plan: {unplanned}")
    if not tables:
        return []
    for t in tables[1:]:
        if t.names != tables[0].names:
            raise CylonError(Code.Invalid, "task tables must share a schema")

    # tag + concatenate: one combined table with a task-id routing column
    combined = None
    for t, task in zip(tables, task_ids):
        tagged = t.project(list(range(len(t.names))))  # shallow copy
        tagged[TASK_COL] = np.full((t.row_count,), task, np.int64)
        combined = tagged if combined is None else combined.merge(tagged)

    shuffled = _plan_shuffle(combined, plan)
    return [shuffled.select(_task_predicate(task)).drop([TASK_COL])
            for task in task_ids]


def _task_predicate(task: int):
    """The row predicate selecting one task's rows (the reference caches
    one per task for its jit cache keys; the port has no such cache)."""
    def pred(env):
        return env[TASK_COL] == task

    return pred


def _plan_shuffle(t, plan: LogicalTaskPlan):
    """Shuffle with plan-lookup routing instead of key hashing (the analog
    of ArrowTaskAllToAll::insert routing through plan.worker_num_of):
    padding rows get target ``world``."""
    from . import ops as par_ops
    from . import plane as plane_mod
    from . import shuffle as shuffle_mod

    world = t.num_shards
    devices = t.ctx.devices
    task_idx = t.names.index(TASK_COL)
    # dense lookup table task -> worker (tasks may be sparse ids)
    max_task = max(plan.tasks) if plan.tasks else 0
    lut = np.zeros((max_task + 2,), np.int32)
    for task, worker in plan._map.items():
        lut[task] = worker

    def targets(cols, count):
        task_col = cols[task_idx].data
        tgt = torch.as_tensor(lut, device=task_col.device)[
            task_col.clamp(0, len(lut) - 1)]
        live = compact.live_mask(tgt.shape[0], count, tgt.device)
        return torch.where(live, tgt, torch.full((), world, dtype=tgt.dtype,
                                                 device=tgt.device))

    def exchange():
        resilience.fault_point("shuffle")
        pack = plane_mod.pack_enabled()
        with obs_spans.span("shuffle.plan", mode="task", world=world,
                            family="ragged"):
            tgts = [targets(cols, n) for cols, n in zip(t.shards, t.counts)]
            cm = shuffle_mod.count_matrix(
                [shuffle_mod.target_counts(tg, world) for tg in tgts],
                t.ctx.group)
            out_cap = shuffle_mod.plan_shuffle(cm)
        with obs_spans.span("shuffle.exchange", packed=pack, family="ragged",
                            world=world, compressed=False):
            shards, totals = shuffle_mod.shuffle_shard_ragged(
                t.shards, tgts, cm, world, out_cap, devices, packed=pack,
                group=t.ctx.group, shard_ids=t.shard_ids)
        par_ops._record_exchange(t.shards[0], pack, "task-ragged",
                                 int(cm.sum()))
        return t._like(shards, totals)

    out, _attempts = resilience.retry_call(
        exchange, policy=t.ctx.collective_retry_policy(), site="shuffle")
    return out
