"""The port's task-multiplexed all-to-all (``parallel/task.py``) against
the JAX package's, on the same inputs (reference:
arrow/arrow_task_all_to_all.h; the counterparts of
``tests/test_task_shuffle.py``).  Task shuffles route by the plan's lookup
table, not by a hash, so outputs compare shard for shard with the
unpatched reference, exactly."""
import numpy as np
import pytest

from cylon_tpu.parallel import task as rtask
from cylon_tpu.status import CylonError as RCylonError
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table
from cylon_tpu_torch.parallel.task import LogicalTaskPlan, task_shuffle
from cylon_tpu_torch.status import CylonError

from .torch_parity import assert_shards_equal


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


def test_logical_task_plan():
    for plan_cls, err in ((LogicalTaskPlan, CylonError),
                          (rtask.LogicalTaskPlan, RCylonError)):
        plan = plan_cls({0: 0, 1: 2, 2: 2, 5: 3}, world_size=4)
        assert plan.worker_for(1) == 2
        assert plan.tasks_of(2) == [1, 2]
        assert plan.tasks == [0, 1, 2, 5]
        with pytest.raises(err):
            plan_cls({0: 7}, world_size=4)


@pytest.mark.parametrize("pack", ["0", "1"])
def test_task_shuffle_delivery(pctx, ctx4, rng, monkeypatch, pack):
    """Each logical table's rows land entirely on its assigned worker, and
    every output equals the reference's shard for shard (per buffer and
    packed)."""
    monkeypatch.setenv("CYLON_TPU_SHUFFLE_PACK", pack)
    mapping = {0: 3, 1: 1, 2: 1}
    contents = [{"a": rng.integers(0, 100, 50 + 10 * i).astype(np.int64),
                 "b": rng.random(50 + 10 * i)} for i in range(3)]
    outs = task_shuffle([Table.from_pydict(d, ctx=pctx) for d in contents],
                        [0, 1, 2], LogicalTaskPlan(mapping, world_size=4))
    want = rtask.task_shuffle(
        [RTable.from_pydict(d, ctx=ctx4) for d in contents], [0, 1, 2],
        rtask.LogicalTaskPlan(mapping, world_size=4))
    assert len(outs) == 3
    for i, (out, w, data) in enumerate(zip(outs, want, contents)):
        counts = out.row_counts
        assert counts[mapping[i]] == len(data["a"]), (i, counts)
        assert counts.sum() == len(data["a"])  # nothing anywhere else
        got = out.to_numpy()
        np.testing.assert_array_equal(np.sort(got["a"]), np.sort(data["a"]))
        np.testing.assert_array_equal(np.sort(got["b"]), np.sort(data["b"]))
        assert_shards_equal(out, w)


def test_task_shuffle_schema_mismatch(pctx):
    t1 = Table.from_pydict({"a": [1, 2]}, ctx=pctx)
    t2 = Table.from_pydict({"z": [1, 2]}, ctx=pctx)
    with pytest.raises(CylonError):
        task_shuffle([t1, t2], [0, 1], LogicalTaskPlan({0: 0, 1: 1}, 4))
    with pytest.raises(CylonError):
        task_shuffle([t1], [9], LogicalTaskPlan({0: 0}, 4))
    with pytest.raises(CylonError):
        task_shuffle([t1], [0, 1], LogicalTaskPlan({0: 0, 1: 1}, 4))
