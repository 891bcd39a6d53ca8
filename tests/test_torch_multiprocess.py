"""The port's multi-process backend over gloo on the CPU: two processes
joined into one ``torch.distributed`` group (``MeshConfig(num_processes=
2, ...)``), each holding 2 shards (world 4) or 1 (world 2), the port's
counterpart of ``tests/test_multihost.py``.

One gang per layout (``tests/torch_multiprocess_worker.py``) runs every
case under the three exchange realizations, and the out-of-core engines'
mesh passes and ``DataFrame`` verbs once, and saves its local shards
under their global ids (the engines' host frames whole: every process
must return the same frames).  Each case's shards must equal, shard for shard
and bit for bit, a one-process ``MeshConfig(["cpu"], world_size=...)``
run of the same cases; gathered and sorted, they must equal the JAX
package's at world 4 (float sums within rtol 1e-12 of it: the two sum
partials in another order).  The worker's multihost checks (pandas
oracles) are asserted one by one.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from tests import torch_multiprocess_worker as worker

#: (processes, shards per process)
LAYOUTS = ((2, 2), (2, 1))
GANG_TIMEOUT_S = 240
CHECKS = ("rank", "world", "multi_process", "no_retry", "join_count",
          "to_pandas_every_row", "to_pandas_rows", "groups", "sum", "sort",
          "setitem_host", "addressable_ids", "csv_per_shard",
          "fault_surfaces", "mismatched_passes_raise",
          "dataframe_merge_groupby")


def _free_port() -> int:
    # TOCTOU, as tests/test_multihost.py's: process 0 must bind the port
    # itself, so a lost race surfaces as worker.BIND_RACE_RC and retries
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_gang(nprocs: int, local: int, out_dir) -> list:
    script = os.path.join(os.path.dirname(__file__),
                          "torch_multiprocess_worker.py")
    for attempt in range(3):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, script, str(pid), str(nprocs), str(port),
             str(local), str(out_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for pid in range(nprocs)]
        outs = [""] * nprocs
        timed_out = False
        try:
            for i, p in enumerate(procs):
                try:
                    outs[i] = p.communicate(timeout=GANG_TIMEOUT_S)[0].decode()
                except subprocess.TimeoutExpired:
                    timed_out = True
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait(timeout=30)
        if any(p.returncode == worker.BIND_RACE_RC for p in procs) \
                and attempt < 2:
            continue
        assert not timed_out, "a worker hung:\n" + "\n".join(
            o[-2000:] for o in outs)
        break
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} rc={p.returncode}:\n" \
            f"{out[-3000:]}"
    results = []
    for pid in range(nprocs):
        with open(os.path.join(out_dir, f"r{pid}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _merged(procs: list, arm: str, case: str):
    """Every process's shards of one case, under their global ids; the
    host scalars of process 0 (every process must hold the same)."""
    return _merge_records([p["arms"][arm][case] for p in procs])


def _merge_records(recs: list):
    if isinstance(recs[0], list):
        return [_merge_tables([r[i] for r in recs])
                for i in range(len(recs[0]))]
    if "shards" not in recs[0]:  # every process holds the same, bit for bit
        for r in recs[1:]:
            _assert_same_shards(r, recs[0], "every process alike")
        return recs[0]
    return _merge_tables(recs)


def _merge_tables(recs: list) -> dict:
    out = {"names": recs[0]["names"], "dtypes": recs[0]["dtypes"],
           "shards": {}, "counts": {}}
    for r in recs:
        assert r["names"] == out["names"]
        out["shards"].update(r["shards"])
        out["counts"].update(r["counts"])
    return out


def _bits(a):
    return None if a is None else np.ascontiguousarray(a).view(np.uint8)


def _assert_same_shards(got, want, label: str) -> None:
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_shards(g, w, f"{label}[{i}]")
        return
    if "shards" not in want:  # host scalars: equal, floats by their bits
        assert got.keys() == want.keys(), label
        for k in want:
            assert np.array_equal(_bits(np.asarray(got[k])),
                                  _bits(np.asarray(want[k]))), (label, k)
        return
    assert got["names"] == want["names"], label
    assert got["counts"] == want["counts"], (label, got["counts"],
                                             want["counts"])
    assert sorted(got["shards"]) == sorted(want["shards"]), label
    for sid, cols in want["shards"].items():
        for name, g, w in zip(want["names"], got["shards"][sid], cols):
            for buf, gb, wb in zip(("data", "validity", "lengths"), g, w):
                assert (gb is None) == (wb is None), (label, sid, name, buf)
                if wb is not None:
                    assert gb.shape == wb.shape and np.array_equal(
                        _bits(gb), _bits(wb)), (label, sid, name, buf)


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"{p}x{local}" for p, local in LAYOUTS])
def gang(request, tmp_path_factory):
    """(the gang's per-process results, the one-process results of the
    same world) for one layout."""
    from cylon_tpu_torch import CylonContext, MeshConfig

    nprocs, local = request.param
    out_dir = tmp_path_factory.mktemp(f"gang{nprocs}x{local}")
    procs = _run_gang(nprocs, local, out_dir)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as the workers
    try:
        one_ctx = CylonContext.InitDistributed(
            MeshConfig(devices=["cpu"], world_size=nprocs * local))
        one = worker.run_arms(one_ctx)
        one_engine = worker.run_engine(one_ctx)
    finally:
        torch.set_num_threads(threads)
    return {"procs": procs, "one": one, "one_engine": one_engine,
            "layout": (nprocs, local)}


@pytest.mark.parametrize("arm", [a[0] for a in worker.ARMS])
@pytest.mark.parametrize("case", worker.CASES)
def test_shards_equal_one_process(gang, case, arm):
    """Shard for shard, every buffer over the whole capacity."""
    _assert_same_shards(_merged(gang["procs"], arm, case),
                        gang["one"][arm][case], f"{case}/{arm}")


@pytest.mark.parametrize("case", worker.ENGINE_CASES)
def test_engine_equals_one_process(gang, case):
    """The out-of-core engines over the group (every process plans the
    same passes, each pass's frame gathered) and ``DataFrame`` over the
    group: every process's frames, bit for bit, equal one process's; the
    repartition's targets and the merge's shards shard for shard, with
    the global per-target counts."""
    got = _merge_records([p["engine"][case] for p in gang["procs"]])
    _assert_same_shards(got, gang["one_engine"][case], case)


@pytest.mark.parametrize("check", CHECKS)
def test_multihost_checks(gang, check):
    """``tests/multihost_worker.py``'s checks on every process, with the
    no-retry policy and a shuffle fault that surfaces at once."""
    for pid, p in enumerate(gang["procs"]):
        ok, detail = p["checks"][check]
        assert ok, f"process {pid}: {check}: {detail}"


# -- gathered and sorted, against the JAX package at world 4 ---------------

#: cases whose gathered rows the JAX package computes the same way
REFERENCE_CASES = ("join_sort", "join_hash", "join_left", "groupby_hash",
                   "groupby_pipeline", "nunique", "scalars", "sort",
                   "unique", "intersect", "string_join", "string_groupby",
                   "tiny_join", "tiny_groupby", "empty_join", "skew_groupby")


@pytest.fixture(scope="module")
def reference(ctx4):
    return {k: v for k, v in worker.run_cases(ctx4, "cylon_tpu").items()
            if k in REFERENCE_CASES}


def _frame(rec) -> pd.DataFrame:
    """A merged shard record's live rows as a sorted frame."""
    from cylon_tpu_torch import CylonContext, MeshConfig, interop

    ids = sorted(rec["shards"])
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                  world_size=len(ids)))
    t = interop.table_from_shard_arrays(
        rec["names"], [[(d, v, ln, dt) for (d, v, ln), dt in
                        zip(rec["shards"][s], rec["dtypes"])] for s in ids],
        [rec["counts"][s] for s in ids], ctx)
    return _sorted(t.to_pandas())


def _sorted(df: pd.DataFrame) -> pd.DataFrame:
    return df.sort_values(list(df.columns)).reset_index(drop=True)


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_gathered_equal_reference(gang, reference, case):
    got = _merged(gang["procs"], "per_buffer", case)
    want = reference[case]
    if "shards" not in got:
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-12, err_msg=k)
        return
    pd.testing.assert_frame_equal(_frame(got), _sorted(want.to_pandas()),
                                  check_dtype=False, check_exact=False,
                                  rtol=1e-12, atol=0)


@pytest.mark.parametrize("case,key", [("shuffle", "l"),
                                      ("skew_shuffle", "skew")])
def test_shuffle_moves_every_row(gang, case, key):
    """A shuffle is a permutation of the input rows, and equal keys share
    a shard."""
    got = _merged(gang["procs"], "compressed", case)
    want = _sorted(pd.DataFrame(worker.inputs()[key]))
    pd.testing.assert_frame_equal(_frame(got), want, check_dtype=False)
    owner = {}
    for sid, cols in got["shards"].items():
        for k in cols[0][0][:got["counts"][sid]]:
            assert owner.setdefault(int(k), sid) == sid


def test_broadcast_and_task_rows(gang):
    """``broadcast_gather``: every shard holds every row of ``r`` in
    source order; ``task_shuffle``: each task's rows on its worker only."""
    inp = worker.inputs()
    b = _merged(gang["procs"], "per_buffer", "broadcast")
    for sid, cols in b["shards"].items():
        n = b["counts"][sid]
        assert n == worker.ROWS_R
        np.testing.assert_array_equal(cols[0][0][:n], inp["r"]["k"])
    world = len(b["shards"])
    tasks = _merged(gang["procs"], "per_buffer", "task")
    for out, worker_id, rows in ((tasks[0], 1, worker.ROWS_L),
                                 (tasks[1], world - 1, 50)):
        assert {s: n for s, n in out["counts"].items() if n} == \
            {worker_id: rows}


def test_worker_imports_no_jax():
    """The worker, like the port, imports neither jax nor the JAX
    package."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "import tests.torch_multiprocess_worker as w, cylon_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'cylon_tpu.')) or m == 'cylon_tpu']; "
            "print(bad); assert not bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def test_one_process_group_equals_the_mesh(tmp_path):
    """A group of one process (how one card runs the group path) gives
    the in-process mesh's shards, bit for bit, through the collectives
    (gloo here, NCCL on the card)."""
    code = f"""
import pickle, sys
sys.path.insert(0, '.')
import torch
torch.set_num_threads(2)
from cylon_tpu_torch import CylonContext, MeshConfig
from tests import torch_multiprocess_worker as w
g = CylonContext.InitDistributed(MeshConfig(devices=['cpu'], world_size=3,
                                            num_processes=1))
assert g.group is not None and not g.multi_process() and g.GetRank() == 0
assert g.collective_retry_policy().max_retries > 0
res = {{k: w.shards_of(v) for k, v in w.run_cases(g).items()}}
g.Finalize()
one = CylonContext.InitDistributed(MeshConfig(devices=['cpu'], world_size=3))
want = {{k: w.shards_of(v) for k, v in w.run_cases(one).items()}}
pickle.dump((res, want), open(r'{tmp_path / "one.pkl"}', 'wb'))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=GANG_TIMEOUT_S)
    with open(tmp_path / "one.pkl", "rb") as f:
        res, want = pickle.load(f)
    for case in worker.CASES:
        _assert_same_shards(res[case], want[case], case)


def test_group_needs_one_kind_of_device():
    """The backend follows the shards' devices (gloo for the CPU, NCCL
    for CUDA), so shards on both kinds cannot form a group; the context
    refuses before it touches a device."""
    from cylon_tpu_torch import CylonContext, CylonError, MeshConfig

    with pytest.raises(CylonError, match="one kind of device"):
        CylonContext.InitDistributed(MeshConfig(
            devices=["cpu", "cuda"], num_processes=1))


def test_multi_process_refusals_name_a8b(monkeypatch):
    """ROADMAP A8b is done: the out-of-core engine and DataFrame no
    longer refuse a context that spans processes.  The engine runs its
    passes on it, and DataFrame uses it as given (no mesh of its own)."""
    from cylon_tpu_torch import (CylonContext, DataFrame, MeshConfig,
                                 exec as exec_mod)

    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                  world_size=2))
    monkeypatch.setattr(ctx, "multi_process", lambda: True)
    res, stats = exec_mod.chunked_groupby(
        {"k": np.arange(4), "v": np.ones(4)}, ["k"], {"v": ["sum"]},
        passes=2, ctx=ctx)
    assert stats["world"] == 2 and sorted(res["k"]) == [0, 1, 2, 3]
    df = DataFrame({"a": [1, 2]}, ctx=ctx)
    assert df.context is ctx and df.to_dict() == {"a": [1, 2]}
