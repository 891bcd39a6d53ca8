"""The port's durable execution (``cylon_tpu_torch/durable.py``,
``durable_sync.py``, ``durable_lease.py``): journaled spill-to-disk
checkpoints, cross-process crash-resume, pass deadlines, poison-pass
quarantine, the GC lease, scrubbing, read-repair, replication and
``tools/journal_fsck.py`` on a root the port wrote.

All 46 of ``tests/test_durable.py``'s cases, under the same names and at
the same sizes, on the CPU (``ctx=CylonContext.Init("cpu")``), two of
them through the elastic coordinator's journal placement.  Then the
cases across
the two packages: a frame spills to the same bytes (and sha256) in both,
each package's ``RunJournal`` loads a run the other wrote, and a
journaled (and resumed) port engine run equals the reference's
unjournaled ``chunked_join_groupby_tables`` (``torch_parity``, rtol 1e-5
for float32).  Fingerprints differ between the packages by design (the
port's ``trace_cache_token`` folds other knobs), so the cross-package
cases compare spills, manifests and loads, never fingerprint values.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cylon_tpu import durable as rdurable
from cylon_tpu import exec as rexec
from cylon_tpu_torch import CylonContext, config, durable, durable_sync
from cylon_tpu_torch import resilience
from cylon_tpu_torch.exec import (chunked_groupby, chunked_join_groupby_tables,
                                  chunked_sort)
from cylon_tpu_torch.io import arrow_io
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.status import Code, CylonError

from .torch_parity import assert_frames_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = CylonContext.Init("cpu")


def _join_inputs(rng, n=3000):
    left = {"k": rng.integers(0, n, n).astype(np.int64),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int64),
             "b": rng.random(n).astype(np.float32)}
    return left, right


def _run(left, right, passes=4):
    return chunked_join_groupby_tables(
        left, right, on="k", how="inner", group_by="l_k",
        agg={"a": ["sum"], "b": ["mean"]}, passes=passes, mode="hash",
        ctx=CPU)


def _assert_bit_identical(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)
        if x.dtype.kind == "f":  # equal NaNs aren't enough: same BITS
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# frame spill round trip + checksum rejection
# ---------------------------------------------------------------------------

def test_frame_ipc_roundtrip_exact():
    """Every frame shape ``column.to_numpy`` emits survives the Arrow IPC
    spill bit-identically — dtype included (an object column must come
    back object, or a resumed concat would change the output dtype)."""
    frame = {
        "i64": np.array([1, -2, 2**62], np.int64),
        "i32": np.array([7, -7, 0], np.int32),
        "f32": np.array([1.5, np.nan, -0.0], np.float32),
        "f64": np.array([np.pi, np.inf, -np.inf], np.float64),
        "bool": np.array([True, False, True]),
        "dt": np.array(["2020-01-01", "NaT", "1970-01-02"], "datetime64[us]"),
        "u": np.array(["xy", "", "abc"], "U3"),
        "obj_f64": np.array([np.float64(2.5), None, np.float64(np.nan)],
                            object),
        "obj_i64": np.array([np.int64(5), None, np.int64(-5)], object),
        "obj_str": np.array(["a", None, "ccc"], object),
        "obj_bytes": np.array([b"\xff\x00", None, b"ok"], object),
        "obj_null": np.array([None, None, None], object),
    }
    back = arrow_io.frame_from_ipc_bytes(arrow_io.frame_to_ipc_bytes(frame))
    assert set(back) == set(frame)
    for k, a in frame.items():
        b = back[k]
        assert b.dtype == a.dtype, (k, a.dtype, b.dtype)
        if a.dtype == object:
            for x, y in zip(a, b):
                if x is None:
                    assert y is None, k
                elif isinstance(x, float) and np.isnan(x):
                    assert np.isnan(y), k
                else:
                    assert x == y, k
                    assert np.asarray(x).dtype == np.asarray(y).dtype, k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
            if a.dtype.kind == "f":
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8), err_msg=k)


def test_frame_ipc_empty_and_zero_rows():
    for frame in ({}, {"x": np.zeros(0, np.int32),
                       "s": np.zeros(0, object)}):
        back = arrow_io.frame_from_ipc_bytes(
            arrow_io.frame_to_ipc_bytes(frame))
        assert set(back) == set(frame)
        for k in frame:
            assert back[k].dtype == np.asarray(frame[k]).dtype
            assert len(back[k]) == 0


def test_journal_checksum_rejects_truncated_spill(tmp_path):
    """A spill truncated after commit (torn write, disk corruption) fails
    its manifest checksum on load and the pass re-executes — never served
    as garbage."""
    frame = {"k": np.arange(10, dtype=np.int64),
             "v": np.linspace(0, 1, 10).astype(np.float32)}
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j = durable.open_run("f" * 64, "test")
        j.record_pass(0, 0, frame, 10)
        loaded, rows = j.load_pass(0, 0)
        assert rows == 10
        _assert_bit_identical(loaded, frame)
        # reopen fresh (the resume path) and truncate the spill
        j2 = durable.open_run("f" * 64, "test")
        assert j2.completed_count() == 1
        spill = tmp_path / ("f" * 64) / "pass_L0_P0.arrow"
        data = spill.read_bytes()
        spill.write_bytes(data[:len(data) // 2])
        obs_metrics.reset()
        assert j2.load_pass(0, 0) is None
        assert obs_metrics.counter_value("durable.spills_rejected") == 1
        assert j2.load_pass(0, 0) is None  # record dropped, stays dropped
    obs_metrics.reset()


def test_journal_refuses_foreign_fingerprint(tmp_path):
    """A manifest recording a different run fingerprint is refused — stale
    spills must never leak into another run's output."""
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        durable.open_run("a" * 64, "test")
        manifest = tmp_path / ("a" * 64) / durable.MANIFEST
        lines = manifest.read_text().splitlines()
        header = json.loads(lines[0])
        header["fingerprint"] = "b" * 64
        manifest.write_text(json.dumps(header) + "\n")
        with pytest.raises(CylonError) as ei:
            durable.open_run("a" * 64, "test")
        assert ei.value.code == Code.Invalid
        assert "refusing stale spills" in ei.value.msg


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------

def test_run_fingerprint_sensitivity(rng):
    left, right = _join_inputs(rng, n=200)
    frames = ((list(left), left), (list(right), right))
    fp = durable.run_fingerprint("join", (1, "hash"), frames)
    assert fp == durable.run_fingerprint("join", (1, "hash"), frames)
    assert fp != durable.run_fingerprint("join", (2, "hash"), frames)
    assert fp != durable.run_fingerprint("sort", (1, "hash"), frames)
    bumped = dict(left, a=left["a"] + 1)
    assert fp != durable.run_fingerprint(
        "join", (1, "hash"), ((list(bumped), bumped), (list(right), right)))
    # a result-affecting trace knob changes the fingerprint too
    with config.knob_env(CYLON_TPU_ACCUM="wide"):
        assert fp != durable.run_fingerprint("join", (1, "hash"), frames)


def test_run_fingerprint_full_content_coverage():
    """Coverage is FULL, not sampled: changing a single element at ANY
    index of a large column (fixed-width or object) must change the
    fingerprint — a stale journal must never serve modified inputs."""
    n = 100_000
    base = {"x": np.zeros(n, np.int64)}
    fp = durable.run_fingerprint("join", (), ((["x"], base),))
    for idx in (1, n // 3, n - 2):
        mod = {"x": base["x"].copy()}
        mod["x"][idx] = 1
        assert fp != durable.run_fingerprint("join", (), ((["x"], mod),)), idx
    # element order matters too (position-mixed fold, not a plain xor)
    swapped = {"x": base["x"].copy()}
    swapped["x"][0], swapped["x"][1] = 1, 0
    mod2 = {"x": base["x"].copy()}
    mod2["x"][0], mod2["x"][1] = 0, 1
    assert (durable.run_fingerprint("join", (), ((["x"], swapped),))
            != durable.run_fingerprint("join", (), ((["x"], mod2),)))
    strs = {"s": np.array(["row%d" % i for i in range(n // 10)], object)}
    fps = durable.run_fingerprint("join", (), ((["s"], strs),))
    mod3 = {"s": strs["s"].copy()}
    mod3["s"][7] = "ROW7"
    assert fps != durable.run_fingerprint("join", (), ((["s"], mod3),))


def test_run_fingerprint_none_vs_literal_none_string():
    """str() coercion maps None -> "None": the element KIND must
    disambiguate, or a null column and a column holding the literal
    string would share a journal (stale spills served as wrong data)."""
    a = {"c": np.array([None, "x"], object)}
    b = {"c": np.array(["None", "x"], object)}
    assert (durable.run_fingerprint("t", (1,), ((["c"], a),))
            != durable.run_fingerprint("t", (1,), ((["c"], b),)))
    # bytes vs a str equal to their repr likewise
    c = {"c": np.array([b"x", "y"], object)}
    d = {"c": np.array(["b'x'", "y"], object)}
    assert (durable.run_fingerprint("t", (1,), ((["c"], c),))
            != durable.run_fingerprint("t", (1,), ((["c"], d),)))


@pytest.mark.fault
def test_unusable_durable_dir_disables_journal_not_the_run(rng, tmp_path):
    """A journal root that cannot be used (a regular file in the way)
    disables journaling with a warning — the run itself completes."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    left, right = _join_inputs(rng, n=800)
    base, _ = _run(left, right, passes=2)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(blocker)):
        res, stats = _run(left, right, passes=2)
    assert "passes_skipped" not in stats  # no journal was active
    assert stats["parts_run"] == stats["passes"]
    _assert_bit_identical(res, base)


@pytest.mark.fault
def test_journaled_overrun_never_quarantined(rng, tmp_path):
    """QUARANTINE_AFTER=1 + a deadline overrun whose frame was already
    journaled: the serve-from-journal path must win over quarantine —
    rows committed to the journal are never dropped from the output."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right, passes=3)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_PASS_DEADLINE_S="1.0",
                         CYLON_TPU_QUARANTINE_AFTER="1",
                         CYLON_TPU_RETRY_MAX="0",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("host_fetch@2=hang") as plan:
            res, stats = _run(left, right, passes=3)
    assert plan.fired == [("host_fetch", "hang", 2)]
    assert "quarantined" not in stats
    assert stats["passes_skipped"] == 1
    _assert_bit_identical(res, base)


# ---------------------------------------------------------------------------
# in-process resume (same engine path a fresh process takes)
# ---------------------------------------------------------------------------

@pytest.mark.fault
def test_journal_resume_skips_completed_passes(rng, tmp_path):
    left, right = _join_inputs(rng)
    base, base_stats = _run(left, right)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        r1, s1 = _run(left, right)
        obs_metrics.reset()
        r2, s2 = _run(left, right)
    assert s1["passes_skipped"] == 0
    assert s2["passes_skipped"] == s2["passes"] == base_stats["passes"]
    assert "parts_run" not in s2  # a fully journaled run executes nothing
    assert obs_metrics.counter_value("durable.passes_skipped") == s2["passes"]
    _assert_bit_identical(r1, base)
    _assert_bit_identical(r2, base)
    obs_metrics.reset()


@pytest.mark.fault
def test_resume_with_changed_input_reuses_nothing(rng, tmp_path):
    """Changing ONE input value changes the run fingerprint: the journal
    of the old run must not serve a single pass."""
    left, right = _join_inputs(rng)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        _run(left, right)
        left2 = dict(left, a=left["a"] + np.float32(1))
        _, s2 = _run(left2, right)
    assert s2["passes_skipped"] == 0
    assert s2["parts_run"] == s2["passes"]


@pytest.mark.fault
def test_corrupted_spill_reexecutes_only_that_pass(rng, tmp_path):
    """journal_corrupt fault kind: the spill committed for one pass is
    truncated mid-run; the resume rejects exactly that pass's record and
    re-executes it while still skipping every intact pass."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        with resilience.fault_plan("journal_commit@2=journal_corrupt") as p:
            r1, s1 = _run(left, right)
        assert p.fired == [("journal_commit", "journal_corrupt", 2)]
        obs_metrics.reset()
        r2, s2 = _run(left, right)
    assert s1["passes_skipped"] == 0
    assert s2["passes_skipped"] == s2["passes"] - 1
    assert s2["parts_run"] == 1
    assert obs_metrics.counter_value("durable.spills_rejected") == 1
    _assert_bit_identical(r1, base)
    _assert_bit_identical(r2, base)
    obs_metrics.reset()


@pytest.mark.fault
def test_groupby_and_sort_runs_journal_too(rng, tmp_path):
    n = 2000
    data = {"g": rng.integers(0, 50, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32)}
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        g1, gs1 = chunked_groupby(data, "g", {"v": ["sum"]}, passes=3,
                                  ctx=CPU)
        g2, gs2 = chunked_groupby(data, "g", {"v": ["sum"]}, passes=3,
                                  ctx=CPU)
        s1, ss1 = chunked_sort(data, "v", passes=3, ctx=CPU)
        s2, ss2 = chunked_sort(data, "v", passes=3, ctx=CPU)
    assert gs1.get("passes_skipped") == 0
    assert gs2["passes_skipped"] == gs2["passes"]
    assert ss1.get("passes_skipped") == 0
    assert ss2["passes_skipped"] == ss2["passes"]
    _assert_bit_identical(g2, g1)
    _assert_bit_identical(s2, s1)


# ---------------------------------------------------------------------------
# cross-process crash-resume (the acceptance criterion)
# ---------------------------------------------------------------------------

def _worker_env(tmp_path, **knobs):
    env = dict(os.environ)
    env.pop("CYLON_TPU_FAULT_PLAN", None)
    env["CYLON_TPU_DURABLE_DIR"] = str(tmp_path / "journal")
    env.update({k: v for k, v in knobs.items() if v is not None})
    return env


def _invoke_worker(tmp_path, tag, env):
    out = tmp_path / f"{tag}.npz"
    stats = tmp_path / f"{tag}.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_durable_worker.py"),
         str(out), str(stats)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    return proc, out, stats


@pytest.mark.fault
def test_killhard_crash_then_fresh_process_resumes_bit_identical(
        rng, tmp_path):
    """kill -9 mid-journal (os._exit inside the spill/manifest window),
    then a FRESH process re-invokes the identical run: it must complete
    from the journal, re-execute ONLY the unfinished parts, and produce
    bit-identical output to an uninterrupted run — and equal to the
    reference's unjournaled run of the same inputs."""
    from tests import torch_durable_worker as durable_worker

    # the uninterrupted golden, computed in-process on the worker's
    # deterministic inputs (same engine path, no journal)
    left, right = durable_worker.inputs(7)
    base, base_stats = durable_worker.run(left, right)

    killed, _, _ = _invoke_worker(
        tmp_path, "killed",
        _worker_env(tmp_path,
                    CYLON_TPU_FAULT_PLAN="journal_commit@3=killhard"))
    assert killed.returncode == 137, (killed.returncode, killed.stderr[-2000:])

    resumed, out, stats_path = _invoke_worker(
        tmp_path, "resumed", _worker_env(tmp_path))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    stats = json.loads(stats_path.read_text())
    # 2 passes were committed before the kill (the 3rd died mid-commit):
    # the fresh process must skip exactly those and run only the rest
    assert stats["passes_skipped"] == 2
    assert stats["parts_run"] == base_stats["passes"] - 2

    got = dict(np.load(out, allow_pickle=True))
    order = np.argsort(base["l_k"], kind="stable")
    expected = {k: np.asarray(v)[order] for k, v in base.items()}
    _assert_bit_identical(got, expected)
    want, _ = rexec.chunked_join_groupby_tables(
        left, right, on="k", how="inner", group_by="l_k",
        agg={"a": ["sum"], "b": ["mean"]},
        passes=durable_worker.N_PASSES, mode="hash")
    order = np.argsort(want["l_k"], kind="stable")
    assert_frames_equal({k: got[k] for k in want},
                        {k: np.asarray(v)[order] for k, v in want.items()})


# ---------------------------------------------------------------------------
# pass deadlines -> Code.Timeout
# ---------------------------------------------------------------------------

def test_pass_deadline_classifies_timeout():
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_PASS_DEADLINE_S="0.02"):
        dl = durable.pass_deadline("unit")
        with dl:
            time.sleep(0.06)
        # the raise is decoupled from __exit__ so callers can journal a
        # late-but-complete frame before classifying the overrun
        with pytest.raises(CylonError) as ei:
            dl.raise_if_fired()
    assert ei.value.code == Code.Timeout
    assert "CYLON_TPU_PASS_DEADLINE_S" in ei.value.msg
    assert obs_metrics.counter_value("deadline.fired") == 1
    obs_metrics.reset()


@pytest.mark.fault
def test_deadline_overrun_classified_timeout_served_from_journal(
        rng, tmp_path):
    """With a journal, a deadline overrun classifies as Code.Timeout
    AFTER the late frame is journaled — the retry loads it from the
    journal instead of re-executing an identically-slow pass forever."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right, passes=3)
    obs_spans.reset()
    obs_metrics.reset()
    try:
        # RETRY_MAX=0 proves the served-from-journal path consumes no
        # retry budget: the overrun is classified Code.Timeout yet the
        # run cannot die of it, because the result is already durable
        with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                             CYLON_TPU_PASS_DEADLINE_S="1.0",
                             CYLON_TPU_RETRY_MAX="0",
                             CYLON_TPU_RETRY_BASE_S="0",
                             CYLON_TPU_TRACE="1"):
            with resilience.fault_plan("host_fetch@2=hang") as plan:
                res, stats = _run(left, right, passes=3)
        assert plan.fired == [("host_fetch", "hang", 2)]
        assert "retries" not in stats  # no budget spent
        served = [e for e in obs_spans.events()
                  if e.name == "exec.pass_served_from_journal"]
        assert [e.attrs["code"] for e in served] == ["Timeout"]
        assert obs_metrics.counter_value("deadline.fired") == 1
        # the overrun pass completed, was journaled, and the stream
        # served the journaled frame — no second execution
        assert stats["passes_skipped"] == 1
        assert stats["parts_run"] == stats["passes"] - 1
        _assert_bit_identical(res, base)
    finally:
        obs_spans.reset()
        obs_metrics.reset()


def test_pass_deadline_disabled_is_free():
    with config.knob_env(CYLON_TPU_PASS_DEADLINE_S=None):
        cm = durable.pass_deadline()
        assert cm is durable.pass_deadline()  # shared no-op singleton
        with cm:
            pass


def test_pass_deadline_prefers_inflight_exception():
    """An exception raised inside the block wins over the deadline: its
    classification is more specific than 'late'."""
    with config.knob_env(CYLON_TPU_PASS_DEADLINE_S="0.01"):
        with pytest.raises(ValueError):
            with durable.pass_deadline("unit"):
                time.sleep(0.03)
                raise ValueError("the real failure")


@pytest.mark.fault
def test_engine_deadline_without_journal_accepts_late_result(rng):
    """Without a journal to serve a retry from, a late-but-complete pass
    is KEPT (deadline.accepted_late) instead of discarded — discarding
    would condemn every consistently-slow pass to retry-until-fatal."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right, passes=3)
    obs_metrics.reset()
    try:
        # the deadline must sit far above a real pass's cost (first passes
        # pay host slicing + dispatch, ~hundreds of ms on a loaded CI box)
        # while the `hang` kind sleeps 1.5x past it deterministically
        with config.knob_env(CYLON_TPU_PASS_DEADLINE_S="1.0",
                             CYLON_TPU_RETRY_BASE_S="0"):
            with resilience.fault_plan("host_fetch@2=hang") as plan:
                res, stats = _run(left, right, passes=3)
        assert plan.fired == [("host_fetch", "hang", 2)]
        assert "retries" not in stats  # no retry: the late frame is kept
        assert stats["parts_run"] == stats["passes"]
        assert obs_metrics.counter_value("deadline.fired") == 1
        assert obs_metrics.counter_value("deadline.accepted_late") == 1
        _assert_bit_identical(res, base)
    finally:
        obs_metrics.reset()


# ---------------------------------------------------------------------------
# poison-pass quarantine
# ---------------------------------------------------------------------------

@pytest.mark.fault
def test_quarantine_report_contract(rng):
    """A part failing the same way N consecutive times is isolated into
    stats["quarantined"] (part, level, code, failures, msg) and the rest
    of the stream completes — instead of exhausting retries fatally."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right, passes=3)
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_QUARANTINE_AFTER="2",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("host_fetch@1=comm;host_fetch@2=comm"):
            res, stats = _run(left, right, passes=3)
    q = stats["quarantined"]
    assert len(q) == 1
    assert q[0]["part"] == 0 and q[0]["level"] == 0
    assert q[0]["code"] == "ExecutionError" and q[0]["failures"] == 2
    assert "connection reset" in q[0]["msg"]
    assert stats["parts_run"] == 2
    assert obs_metrics.counter_value("quarantine.parts") == 1
    # the surviving parts' rows are exact; the poisoned part's are absent
    assert 0 < len(res["l_k"]) < len(base["l_k"])
    assert set(res["l_k"].tolist()) < set(base["l_k"].tolist())
    obs_metrics.reset()


@pytest.mark.fault
def test_quarantine_never_swallows_bugs(rng):
    """Unknown-classified failures (a TypeError, an INTERNAL error) stay
    fatal no matter how often they repeat — quarantine is for recoverable
    codes only."""
    left, right = _join_inputs(rng, n=500)
    with config.knob_env(CYLON_TPU_QUARANTINE_AFTER="1",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("host_fetch@1+=unknown"):
            with pytest.raises(Exception) as ei:
                _run(left, right, passes=2)
    assert resilience.classify(ei.value) == Code.UnknownError


@pytest.mark.fault
def test_quarantine_fires_at_retry_exhaustion_for_large_n(rng):
    """CYLON_TPU_QUARANTINE_AFTER larger than the retry budget still
    quarantines: a failure that would otherwise be fatal (retries
    exhausted) isolates the part instead of killing the run."""
    left, right = _join_inputs(rng)
    with config.knob_env(CYLON_TPU_QUARANTINE_AFTER="10",
                         CYLON_TPU_RETRY_MAX="1",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("host_fetch@1=comm;host_fetch@2=comm"):
            res, stats = _run(left, right, passes=3)
    q = stats["quarantined"]
    assert len(q) == 1 and q[0]["part"] == 0
    assert "retries exhausted" in q[0]["msg"]
    assert stats["parts_run"] == 2
    assert len(res["l_k"]) > 0


def test_frame_ipc_mixed_object_column_refuses():
    """A non-uniform object column (f64 after f32, i64 after i32) must
    REFUSE to serialize — silent numpy casting would corrupt the spill
    and the checksum would bless it."""
    for bad in ([np.float32(1.5), None, np.float64(2.5)],
                [np.int32(1), np.int64(2), None]):
        with pytest.raises(CylonError) as ei:
            arrow_io.frame_to_ipc_bytes({"x": np.array(bad, object)})
        assert ei.value.code == Code.SerializationError


def test_spill_error_disables_journal_not_the_run(tmp_path):
    """A frame the spiller refuses (mixed-dtype object column) disables
    journaling for the run — counted, warned, record_pass returns False
    — but never raises: durability is best-effort."""
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j = durable.open_run("c" * 64, "test")
        mixed = {"x": np.array([np.float32(1.5), np.float64(2.5), None],
                               object)}
        assert j.record_pass(0, 0, mixed, 3) is False
        assert obs_metrics.counter_value("durable.spill_errors") == 1
        assert j.load_pass(0, 0) is None
        # journaling stays off for the rest of the run — even good frames
        good = {"x": np.arange(3, dtype=np.int64)}
        assert j.record_pass(0, 1, good, 3) is False
        assert j.load_pass(0, 1) is None
    obs_metrics.reset()


@pytest.mark.fault
def test_quarantine_disabled_by_default(rng):
    """With the knob unset (default 0) the fail-fast contract is
    unchanged: exhausted retries raise."""
    left, right = _join_inputs(rng, n=500)
    with config.knob_env(CYLON_TPU_RETRY_MAX="1",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("host_fetch@1+=comm"):
            with pytest.raises(CylonError) as ei:
                _run(left, right, passes=2)
    assert ei.value.code == Code.ExecutionError
    assert "retries exhausted" in ei.value.msg


# ---------------------------------------------------------------------------
# degraded mode: a full shared disk loses durability, never the answer
# ---------------------------------------------------------------------------

@pytest.mark.fault
def test_disk_full_fault_degrades_run_not_failed(rng, tmp_path):
    """An injected ENOSPC at the spill write (`disk_full` — the real
    errno a full shared CYLON_TPU_DURABLE_DIR produces) degrades the run
    to journal-off execution: the answer is still served bit-identical,
    classified `ResourceExhausted` in the trace and counted under
    ``durable.degraded`` — never an UnknownError, never a failed pass."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right, passes=3)
    obs_spans.reset()
    obs_metrics.reset()
    try:
        with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                             CYLON_TPU_TRACE="1"):
            with resilience.fault_plan("journal_spill@1=disk_full") as plan:
                res, _ = _run(left, right, passes=3)
        assert plan.fired == [("journal_spill", "disk_full", 1)]
        _assert_bit_identical(res, base)
        assert obs_metrics.counter_value("durable.degraded") == 1
        # disk pressure is NOT an anonymous IO bug: the operator signal
        # stays separable
        assert obs_metrics.counter_value("durable.spill_errors") == 0
        assert obs_metrics.counter_value("durable.passes_journaled") == 0
        degraded = [e for e in obs_spans.events()
                    if e.name == "durable.degraded"]
        assert [e.attrs["code"] for e in degraded] == ["ResourceExhausted"]
    finally:
        obs_spans.reset()
        obs_metrics.reset()


def test_quota_budget_degrades_to_journal_off(rng, tmp_path):
    """CYLON_TPU_DURABLE_QUOTA_BYTES refuses the spill UP FRONT (no
    ENOSPC needed): the run completes journal-off, counted once under
    ``durable.degraded``, and nothing lands in the shared root."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right, passes=3)
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_DURABLE_QUOTA_BYTES="1"):
        res, _ = _run(left, right, passes=3)
    _assert_bit_identical(res, base)
    assert obs_metrics.counter_value("durable.degraded") == 1
    assert obs_metrics.counter_value("durable.passes_journaled") == 0
    assert all(not r["complete"] for r in durable.scan_runs(str(tmp_path)))
    obs_metrics.reset()


# ---------------------------------------------------------------------------
# crash-safe shared-journal GC: the advisory lease + LRU-clock re-read
# ---------------------------------------------------------------------------

def _journal_runs(tmp_path, rng, k=3, passes=2):
    """``k`` distinct journaled runs in the shared root; returns
    [(left, right, oracle)] so callers can replay any of them."""
    runs = []
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        for _ in range(k):
            left, right = _join_inputs(rng, n=800)
            base, _ = _run(left, right, passes=passes)
            runs.append((left, right, base))
    return runs


def _stagger_lru(inv):
    """Deterministic LRU order: re-stamp manifest mtimes 10s apart in
    scan order (filesystem timestamps of back-to-back runs can tie)."""
    now = time.time()
    for i, r in enumerate(inv):
        ts = now - 30 + 10 * i
        os.utime(os.path.join(r["dir"], durable.MANIFEST), (ts, ts))


def test_gc_lease_blocks_second_collector_and_breaks_stale(tmp_path, rng):
    """Cross-process GC discipline, rendered in-process: a live GC_LOCK
    lease younger than the TTL makes a second collector back off
    (counted, nothing touched); a stale lease (crashed holder) is broken
    and eviction proceeds LRU-first, releasing the lock after."""
    _journal_runs(tmp_path, rng, k=3)
    inv = durable.scan_runs(str(tmp_path))
    assert len(inv) == 3
    _stagger_lru(inv)
    inv = durable.scan_runs(str(tmp_path))
    total = sum(r["bytes"] for r in inv)
    obs_metrics.reset()
    lease = durable._acquire_gc_lease(str(tmp_path))
    assert lease is not None
    try:
        assert durable.gc_journal(str(tmp_path), cap=total - 1) == (0, 0)
        assert obs_metrics.counter_value("durable.gc_lease_busy") == 1
        assert len(durable.scan_runs(str(tmp_path))) == 3
    finally:
        durable._release_gc_lease(lease)
    # a crashed holder's lease: older than the TTL, broken atomically
    lease = durable._acquire_gc_lease(str(tmp_path))
    old = time.time() - 2 * durable._GC_LEASE_TTL_S
    os.utime(lease, (old, old))
    evicted, freed = durable.gc_journal(str(tmp_path), cap=total - 1)
    assert evicted == 1 and freed > 0
    survivors = {r["fingerprint"] for r in durable.scan_runs(str(tmp_path))}
    assert inv[0]["fingerprint"] not in survivors  # the LRU victim went
    assert inv[1]["fingerprint"] in survivors
    assert inv[2]["fingerprint"] in survivors
    assert not os.path.exists(os.path.join(str(tmp_path), durable.GC_LOCK))
    obs_metrics.reset()


def test_gc_rereads_lru_clock_before_eviction(tmp_path, rng, monkeypatch):
    """The scan->evict window: a replica replaying the LRU victim
    freshens its manifest AFTER our inventory scan — the per-victim
    re-read under the lease spares it this round and the next-LRU run
    is evicted instead (never a half-evicted run under a reader)."""
    _journal_runs(tmp_path, rng, k=3)
    _stagger_lru(durable.scan_runs(str(tmp_path)))
    inv = durable.scan_runs(str(tmp_path))
    victim = inv[0]
    total = sum(r["bytes"] for r in inv)
    orig = durable._acquire_gc_lease

    def freshen_then_acquire(root):
        # the racing replica replays the victim exactly between
        # gc_journal's scan and its lease acquisition
        os.utime(os.path.join(victim["dir"], durable.MANIFEST))
        return orig(root)

    monkeypatch.setattr(durable, "_acquire_gc_lease", freshen_then_acquire)
    obs_metrics.reset()
    evicted, _ = durable.gc_journal(str(tmp_path), cap=total - 1)
    assert evicted == 1
    assert obs_metrics.counter_value("durable.gc_skipped_fresh") == 1
    survivors = {r["fingerprint"] for r in durable.scan_runs(str(tmp_path))}
    assert victim["fingerprint"] in survivors      # freshened -> spared
    assert inv[1]["fingerprint"] not in survivors  # next-LRU went instead
    obs_metrics.reset()


_GC_WORKER_SRC = """\
import sys
from cylon_tpu_torch import durable
ev, fr = durable.gc_journal(sys.argv[1], cap=int(sys.argv[2]))
print(ev, fr)
"""


def test_concurrent_cross_process_gc_never_leaves_torn_run(tmp_path, rng):
    """Two real processes GC the shared root at once under the advisory
    lease: no collector crashes, the lock file is released, and EVERY
    fingerprint still replays bit-identical afterwards — evicted runs
    re-execute, surviving runs load, a torn run is never accepted."""
    runs = _journal_runs(tmp_path, rng, k=3)
    inv = durable.scan_runs(str(tmp_path))
    _stagger_lru(inv)
    smallest = min(r["bytes"] for r in inv)
    env = dict(os.environ)
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GC_WORKER_SRC, str(tmp_path),
         str(smallest)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    evicted = sum(int(out.split()[0]) for out, _ in outs)
    assert evicted >= 1
    assert not os.path.exists(os.path.join(str(tmp_path), durable.GC_LOCK))
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        for left, right, base in runs:
            res, _ = _run(left, right, passes=2)
            _assert_bit_identical(res, base)


_REPLAY_WORKER_SRC = """\
import os, sys, time
root, fp = sys.argv[1], sys.argv[2]
os.environ["CYLON_TPU_DURABLE_DIR"] = root
from cylon_tpu_torch import durable
durable._FRESHEN_MIN_S = 0.0
j = durable.open_run(fp, "join_groupby")
assert j is not None, "journal did not open"
# _open freshened the manifest once; re-age it so this check can only
# pass if LOAD-time freshening (the LRU-clock fix) works
old = time.time() - 3600
os.utime(os.path.join(j.dir, durable.MANIFEST), (old, old))
j._freshened_at = 0.0
keys = sorted(j._passes)
assert keys, "journal has no passes to replay"
assert j.load_pass(*keys[0]) is not None, "journaled pass failed to load"
print("replayed", len(keys))
"""


def test_replaying_process_freshens_gc_lru_clock(tmp_path, rng, monkeypatch):
    """The LRU-clock fix, cross-process: a second process that only
    REPLAYS a run (load_pass, zero writes) advances the manifest mtime,
    so a shared-root GC under pressure evicts the cold run — never the
    one being actively replayed."""
    _journal_runs(tmp_path, rng, k=2)
    inv = durable.scan_runs(str(tmp_path))
    assert len(inv) == 2
    # age BOTH runs deep into the past: only the fix can save either
    old = time.time() - 3600
    for r in inv:
        os.utime(os.path.join(r["dir"], durable.MANIFEST), (old, old))
    cold, hot = inv[0]["fingerprint"], inv[1]["fingerprint"]
    env = dict(os.environ)
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REPLAY_WORKER_SRC, str(tmp_path), hot],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "replayed" in proc.stdout
    inv2 = {r["fingerprint"]: r for r in durable.scan_runs(str(tmp_path))}
    assert inv2[hot]["mtime"] > old + 1800, \
        "load_pass in the replaying process never freshened the LRU clock"
    assert inv2[cold]["mtime"] < old + 1800
    # make the eviction choice purely clock-driven (this process still
    # holds the hot run as its own live journal)
    monkeypatch.setattr(durable, "_LAST_JOURNAL", None)
    total = sum(r["bytes"] for r in inv2.values())
    evicted, _ = durable.gc_journal(str(tmp_path), cap=total - 1)
    assert evicted == 1
    survivors = {r["fingerprint"] for r in durable.scan_runs(str(tmp_path))}
    assert hot in survivors and cold not in survivors


# ---------------------------------------------------------------------------
# self-healing journal: scrubbing, read-repair, anti-entropy,
# disaster recovery
# ---------------------------------------------------------------------------

def _mk_run(root, fp="f" * 64, passes=2, n=24, pin=False):
    """One completed journaled run under ``root``; returns the frame."""
    frame = {"k": np.arange(n, dtype=np.int64),
             "v": np.linspace(0, 1, n).astype(np.float32)}
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(root)):
        j = durable.open_run(fp, "test")
        for p in range(passes):
            j.record_pass(0, p, frame, n)
        j.record_done(passes, passes * n)
        if pin:
            assert j.pin()
    return frame


def _flip_byte(path, offset=None):
    data = bytearray(open(path, "rb").read())
    i = len(data) // 2 if offset is None else offset
    data[i] ^= 0xFF
    open(path, "wb").write(bytes(data))


@pytest.fixture
def no_live_journal(monkeypatch):
    """The scrubber skips the process's own live run dir; these tests
    scrub roots built through the normal API, so detach the global."""
    monkeypatch.setattr(durable, "_LAST_JOURNAL", None)


@pytest.fixture
def peerless():
    durable_sync.set_peers(())
    yield
    durable_sync.set_peers(())


def test_corruption_matrix_classification(tmp_path, no_live_journal,
                                          peerless):
    """The full damage taxonomy, peer-less (so nothing is repairable):
    spill body/header bitrot quarantine, manifest mid-line corruption
    quarantines, a torn manifest TAIL is clean by contract, and a
    damaged PINNED run is never evicted (its bad pass re-executes)."""
    cases = {"body": "a" * 64, "header": "b" * 64, "midline": "c" * 64,
             "tail": "d" * 64, "pinned": "e" * 64}
    for name, fp in cases.items():
        _mk_run(tmp_path, fp=fp, pin=(name == "pinned"))
    # spill body + header flips
    _flip_byte(tmp_path / cases["body"] / "pass_L0_P0.arrow")
    _flip_byte(tmp_path / cases["header"] / "pass_L0_P1.arrow", offset=4)
    _flip_byte(tmp_path / cases["pinned"] / "pass_L0_P0.arrow")
    # manifest mid-line: damage the middle line, keep later lines valid
    mani = tmp_path / cases["midline"] / durable.MANIFEST
    lines = mani.read_text().splitlines()
    lines[1] = lines[1][: len(lines[1]) // 2] + "}garbage{"
    mani.write_text("\n".join(lines) + "\n")
    # manifest torn tail: a half-written trailing record
    mani = tmp_path / cases["tail"] / durable.MANIFEST
    mani.write_text(mani.read_text() + '{"kind": "pa')

    durable._LAST_JOURNAL = None  # _mk_run left the pinned run live
    obs_metrics.reset()
    stats = durable_sync.scrub_once(str(tmp_path))
    assert stats["runs"] == 5
    assert stats["quarantined"] == 3       # body, header, midline
    assert stats["torn"] == 1              # tail stands
    assert stats["repaired"] == 0
    assert obs_metrics.counter_value("durable.scrub_corrupt") == 4
    assert obs_metrics.counter_value("durable.scrub_quarantined") == 3
    survivors = {r["fingerprint"] for r in durable.scan_runs(str(tmp_path))}
    assert survivors == {cases["tail"], cases["pinned"]}
    # the damaged PINNED run stands; its bad pass re-executes at load,
    # the intact pass still serves
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j = durable.open_run(cases["pinned"], "test")
        assert j.load_pass(0, 0) is None
        assert j.load_pass(0, 1) is not None
    # the torn-tail run replays everything before the tear
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j = durable.open_run(cases["tail"], "test")
        assert j.load_pass(0, 0) is not None
    obs_metrics.reset()


def test_scrub_repairs_from_peer_bit_identical(tmp_path, no_live_journal):
    """A bitrotted spill heals from a peer holding a good copy: the run
    survives the scrub and the healed bytes are IDENTICAL to the
    original spill (not merely decodable)."""
    rootA, rootB = tmp_path / "a", tmp_path / "b"
    _mk_run(rootA)
    _mk_run(rootB)
    spill = rootA / ("f" * 64) / "pass_L0_P0.arrow"
    good = spill.read_bytes()
    _flip_byte(spill)
    srv = durable_sync.JournalPeerServer(str(rootB))
    durable_sync.set_peers([srv.address])
    obs_metrics.reset()
    try:
        stats = durable_sync.scrub_once(str(rootA))
    finally:
        durable_sync.set_peers(())
        srv.close()
    assert stats["corrupt"] == 1 and stats["repaired"] == 1, stats
    assert stats["quarantined"] == 0
    assert spill.read_bytes() == good
    assert obs_metrics.counter_value("durable.scrub_repaired") == 1
    obs_metrics.reset()


def test_scrub_skips_live_run_and_busy_lease(tmp_path, peerless):
    """The scrubber never walks the process's own OPEN journal, and
    backs off cleanly when another walker holds the root lease."""
    _mk_run(tmp_path)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j = durable.open_run("f" * 64, "test")
    durable._LAST_JOURNAL = j
    try:
        stats = durable_sync.scrub_once(str(tmp_path))
        assert stats["skipped_live"] == 1 and stats["checked"] == 0
    finally:
        durable._LAST_JOURNAL = None
    lease = durable._acquire_gc_lease(str(tmp_path))
    assert lease is not None
    obs_metrics.reset()
    try:
        stats = durable_sync.scrub_once(str(tmp_path))
    finally:
        durable._release_gc_lease(lease)
    assert stats["skipped_busy"] == 1 and stats["runs"] == 0
    assert obs_metrics.counter_value("durable.scrub_lease_busy") == 1
    obs_metrics.reset()


def test_read_repair_serves_bit_identical_and_heals_disk(tmp_path,
                                                         no_live_journal):
    """load_pass on a bitrotted spill degrades to a peer fetch: the
    caller gets the pass (bit-identical), the local spill is rewritten,
    and a SECOND load serves clean from local disk."""
    rootA, rootB = tmp_path / "a", tmp_path / "b"
    frame = _mk_run(rootA)
    _mk_run(rootB)
    spill = rootA / ("f" * 64) / "pass_L0_P0.arrow"
    good = spill.read_bytes()
    _flip_byte(spill)
    srv = durable_sync.JournalPeerServer(str(rootB))
    durable_sync.set_peers([srv.address])
    obs_metrics.reset()
    try:
        with config.knob_env(CYLON_TPU_DURABLE_DIR=str(rootA)):
            j = durable.open_run("f" * 64, "test")
            loaded = j.load_pass(0, 0)
    finally:
        durable_sync.set_peers(())
        srv.close()
    assert loaded is not None, "read-repair should have healed the load"
    healed, rows = loaded
    _assert_bit_identical(healed, frame)
    assert spill.read_bytes() == good
    assert obs_metrics.counter_value("durable.read_repair") == 1
    assert obs_metrics.counter_value("durable.spills_rejected") == 0
    # second load: clean local serve, no second repair
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(rootA)):
        j2 = durable.open_run("f" * 64, "test")
        assert j2.load_pass(0, 0) is not None
    assert obs_metrics.counter_value("durable.read_repair") == 1
    obs_metrics.reset()


def test_read_repair_without_peers_is_prior_behavior(tmp_path, peerless,
                                                     no_live_journal):
    """RF=1 / no fleet attached: the peer-less contract exactly — a bad
    spill is rejected (counted), the record drops, the pass re-executes.
    No repair traffic, no new counters."""
    _mk_run(tmp_path)
    _flip_byte(tmp_path / ("f" * 64) / "pass_L0_P0.arrow")
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_DURABLE_RF="1"):
        j = durable.open_run("f" * 64, "test")
        assert j.load_pass(0, 0) is None
        assert j.load_pass(0, 1) is not None
    assert obs_metrics.counter_value("durable.spills_rejected") == 1
    assert obs_metrics.counter_value("durable.read_repair") == 0
    assert obs_metrics.counter_value("durable.read_repair_failed") == 0
    assert durable._REPLICATION_GUARD is None
    obs_metrics.reset()


_READ_REPAIR_WORKER_SRC = """\
import os, sys
root, host, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
os.environ["CYLON_TPU_DURABLE_DIR"] = root
import numpy as np
from cylon_tpu_torch import durable, durable_sync
durable_sync.set_peers([(host, port)])
j = durable.open_run("f" * 64, "test")
loaded = j.load_pass(0, 0)
assert loaded is not None, "cross-process read-repair failed"
frame, rows = loaded
np.save(sys.argv[4], frame["v"].view(np.uint8))
print("repaired", rows)
"""


def test_read_repair_across_processes(tmp_path, no_live_journal):
    """Two REAL processes: this one serves its journal over TCP, a
    fresh process with a bitrotted root heals its load from us and
    produces byte-identical column bits."""
    rootA, rootB = tmp_path / "a", tmp_path / "b"
    frame = _mk_run(rootA)
    _mk_run(rootB)
    _flip_byte(rootA / ("f" * 64) / "pass_L0_P0.arrow")
    srv = durable_sync.JournalPeerServer(str(rootB))
    out = tmp_path / "healed.npy"
    env = dict(os.environ)
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    env.pop("CYLON_TPU_FAULT_PLAN", None)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _READ_REPAIR_WORKER_SRC, str(rootA),
             srv.address[0], str(srv.address[1]), str(out)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    finally:
        srv.close()
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "repaired" in proc.stdout
    np.testing.assert_array_equal(np.load(out),
                                  frame["v"].view(np.uint8))


_SYNC_PARTIAL_WORKER_SRC = """\
import sys
from cylon_tpu_torch import durable_sync
host, port, root, fp = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
ok = durable_sync.pull_run((host, port), root, fp)
print("pulled", ok)
"""


@pytest.mark.fault
def test_sync_partial_kill_is_invisible_then_converges(tmp_path,
                                                       no_live_journal):
    """sync_partial fault kind: a replication pull killed hard mid-copy
    (manifest not yet written) leaves NOTHING visible — no manifest, no
    run in the inventory — and a clean re-pull converges bit-identical."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    frame = _mk_run(src, passes=3)
    os.makedirs(dst, exist_ok=True)
    srv = durable_sync.JournalPeerServer(str(src))
    env = dict(os.environ)
    env["CYLON_TPU_FAULT_PLAN"] = "journal_sync_file@2=sync_partial"
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _SYNC_PARTIAL_WORKER_SRC,
             srv.address[0], str(srv.address[1]), str(dst), "f" * 64],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 137, (proc.returncode, proc.stderr[-2000:])
        # mid-copy kill: spills may exist, the manifest must NOT — the
        # half-copied dir is an orphan: no digest advertised, no run
        # visible to open_run/replication (scan_runs still counts its
        # BYTES, deliberately, so GC pressure accounting sees them)
        run_dir = dst / ("f" * 64)
        assert not os.path.exists(run_dir / durable.MANIFEST)
        assert durable.read_manifest(str(run_dir)) is None
        assert durable.journal_digests(str(dst)) == {}
        # convergence: a clean re-pull completes and loads bit-identical
        assert durable_sync.pull_run(srv.address, str(dst), "f" * 64)
    finally:
        srv.close()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(dst)):
        j = durable.open_run("f" * 64, "test")
        assert j.completed_count() == 3
        loaded, rows = j.load_pass(0, 0)
    _assert_bit_identical(loaded, frame)


@pytest.mark.fault
def test_bitrot_fault_kind_rejected_then_bit_identical(rng, tmp_path):
    """bitrot fault kind end to end: one committed spill byte flips
    mid-run; the NEXT invocation rejects exactly that record and the
    replay still completes bit-identical to the oracle."""
    left, right = _join_inputs(rng)
    base, _ = _run(left, right)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        with resilience.fault_plan("journal_commit@2=bitrot") as p:
            r1, s1 = _run(left, right)
        assert p.fired == [("journal_commit", "bitrot", 2)]
        obs_metrics.reset()
        r2, s2 = _run(left, right)
    assert obs_metrics.counter_value("durable.spills_rejected") == 1
    assert s2["passes_skipped"] == s2["passes"] - 1
    _assert_bit_identical(r1, base)
    _assert_bit_identical(r2, base)
    obs_metrics.reset()


_RESTORE_WORKER_SRC = """\
import os, sys
host, port, root = sys.argv[1], int(sys.argv[2]), sys.argv[3]
os.environ["CYLON_TPU_DURABLE_DIR"] = root
import numpy as np
from cylon_tpu_torch import durable, durable_sync
stats = durable_sync.journal_restore(root, [(host, port)])
assert stats["pulled"] >= 1 and stats["failed"] == 0, stats
j = durable.open_run("f" * 64, "test")
assert j.completed_count() == 2, j.completed_count()
frame, rows = j.load_pass(0, 0)
np.save(sys.argv[4], frame["v"].view(np.uint8))
print("restored", stats["pulled"])
"""


def test_journal_restore_rebuilds_empty_root(tmp_path, no_live_journal):
    """Disaster recovery in a FRESH process: an empty journal root is
    rebuilt whole from a peer and immediately serves bit-identical
    passes — the rebuilt journal is a journal, not a copy of files."""
    src, dst = tmp_path / "src", tmp_path / "empty"
    frame = _mk_run(src)
    srv = durable_sync.JournalPeerServer(str(src))
    out = tmp_path / "restored.npy"
    env = dict(os.environ)
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    env.pop("CYLON_TPU_FAULT_PLAN", None)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _RESTORE_WORKER_SRC, srv.address[0],
             str(srv.address[1]), str(dst), str(out)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    finally:
        srv.close()
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "restored" in proc.stdout
    np.testing.assert_array_equal(np.load(out),
                                  frame["v"].view(np.uint8))


def test_gc_respects_replication_guard(tmp_path, rng, no_live_journal):
    """gc_journal never evicts a run the coordinator still counts toward
    the replication factor: the guarded LRU victim is spared (counted),
    the next-LRU run goes instead; clearing the guard restores the plain LRU."""
    _journal_runs(tmp_path, rng, k=3)
    _stagger_lru(durable.scan_runs(str(tmp_path)))
    inv = durable.scan_runs(str(tmp_path))
    victim = inv[0]["fingerprint"]
    total = sum(r["bytes"] for r in inv)
    durable.set_gc_replication_guard(lambda fp: fp == victim)
    obs_metrics.reset()
    try:
        evicted, _ = durable.gc_journal(str(tmp_path), cap=total - 1)
    finally:
        durable.set_gc_replication_guard(None)
    assert evicted == 1
    assert obs_metrics.counter_value("durable.gc_skipped_replication") == 1
    survivors = {r["fingerprint"] for r in durable.scan_runs(str(tmp_path))}
    assert victim in survivors
    assert inv[1]["fingerprint"] not in survivors
    obs_metrics.reset()


def test_run_digest_identity_and_digest_inventory(tmp_path,
                                                  no_live_journal):
    """run_digest: equal committed content -> equal digest across
    DIFFERENT roots; a content change flips it; journal_digests
    inventories every readable run."""
    rootA, rootB = tmp_path / "a", tmp_path / "b"
    _mk_run(rootA)
    _mk_run(rootB)
    da = durable.run_digest(str(rootA / ("f" * 64)))
    db = durable.run_digest(str(rootB / ("f" * 64)))
    assert da is not None and da["complete"] and da["passes"] == 2
    assert da["digest"] == db["digest"]
    _mk_run(rootB, fp="9" * 64, passes=1, n=8)
    dc = durable.run_digest(str(rootB / ("9" * 64)))
    assert dc["digest"] != da["digest"]
    inv = durable.journal_digests(str(rootB))
    assert set(inv) == {"f" * 64, "9" * 64}
    # an orphan (manifest-less) dir is invisible to the inventory
    os.makedirs(rootB / ("0" * 64), exist_ok=True)
    assert set(durable.journal_digests(str(rootB))) == set(inv)


# ---------------------------------------------------------------------------
# tools/journal_fsck.py: the offline scrubber twin's rc contract
# ---------------------------------------------------------------------------

def _fsck(*args):
    env = dict(os.environ)
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "journal_fsck.py"),
         *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_journal_fsck_rc_contract(tmp_path, no_live_journal):
    """rc 0 clean / 1 repaired / 2 quarantined / 3 unreadable, busy
    lease backs off at rc 0 — stdlib-only (no package import)."""
    root = tmp_path / "root"
    _mk_run(root)
    # clean (and --json reports it)
    proc = _fsck(root, "--json")
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] == 1 and report["checked"] == 2
    # torn manifest tail is clean by contract
    mani = root / ("f" * 64) / durable.MANIFEST
    mani.write_text(mani.read_text() + '{"kind": "pa')
    assert _fsck(root).returncode == 0
    # repaired from a peer
    peer_root = tmp_path / "peer"
    _mk_run(peer_root)
    spill = root / ("f" * 64) / "pass_L0_P0.arrow"
    good = spill.read_bytes()
    _flip_byte(spill)
    srv = durable_sync.JournalPeerServer(str(peer_root))
    try:
        proc = _fsck(root, "--repair-from",
                     f"{srv.address[0]}:{srv.address[1]}")
    finally:
        srv.close()
    assert proc.returncode == 1, proc.stderr
    assert spill.read_bytes() == good
    # quarantined without a peer
    _flip_byte(spill)
    proc = _fsck(root)
    assert proc.returncode == 2, proc.stderr
    assert not os.path.exists(root / ("f" * 64))
    # a damaged PINNED run is kept standing but still rc 2
    _mk_run(root, fp="9" * 64, pin=True)
    _flip_byte(root / ("9" * 64) / "pass_L0_P0.arrow")
    proc = _fsck(root, "--json")
    assert proc.returncode == 2
    assert json.loads(proc.stdout)["kept_damaged"] == 1
    assert os.path.exists(root / ("9" * 64) / durable.MANIFEST)
    # busy lease: clean back-off, nothing touched
    lock = root / durable.GC_LOCK
    lock.write_text("{}")
    proc = _fsck(root)
    assert proc.returncode == 0
    assert "retry" in proc.stdout
    lock.unlink()
    # unreadable root
    assert _fsck(root / "nope").returncode == 3


def test_wire_blob_digest_contract():
    """blob_b64/blob_from_b64: bit-exact round trip, transfer-damage
    refusal, and divergence-from-local-manifest refusal."""
    from cylon_tpu_torch.router import wire

    data = bytes(range(256)) * 3
    d = wire.blob_b64(data)
    assert wire.blob_from_b64(d) == data
    sha = d["sha256"]
    assert wire.blob_from_b64(d, expect_sha=sha) == data
    with pytest.raises(CylonError) as ei:
        wire.blob_from_b64(dict(d, sha256="0" * 64))
    assert ei.value.code == Code.IOError
    with pytest.raises(CylonError) as ei:
        wire.blob_from_b64(d, expect_sha="0" * 64)
    assert ei.value.code == Code.IOError
    assert "diverges" in ei.value.msg
    with pytest.raises(CylonError) as ei:
        wire.blob_b64("not bytes")
    assert ei.value.code == Code.SerializationError


# ---------------------------------------------------------------------------
# what waits; the engine's obs events on a faulted resume
# ---------------------------------------------------------------------------

def test_durable_waits_name_their_item():
    """Every case of tests/test_durable.py is ported here under its own
    name: none waits."""
    import ast

    with open(os.path.join(REPO, "tests", "test_durable.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    ported = {n for n in globals() if n.startswith("test_")}
    assert names <= ported, names - ported
    assert len(names) == 46


@pytest.mark.fault
def test_faulted_resume_emits_durable_obs_events(rng, tmp_path):
    """A run that dies fatally mid-stream with a durable journal active,
    re-invoked, shows the resume in the event stream (as
    ``tests/test_exec_chunked.py``'s case of this name): durable.resume on
    journal open, durable.pass_skipped per served part, a matching
    durable.passes_skipped counter, and parts_run covering only the
    re-executed tail."""
    from cylon_tpu_torch.exec import chunked_join_groupby

    n = 20_000
    lk = rng.integers(0, n, n).astype(np.int32)
    lv = rng.random(n).astype(np.float32)
    rk = rng.integers(0, n, n).astype(np.int32)
    rv = rng.random(n).astype(np.float32)
    base, base_stats = chunked_join_groupby(lk, lv, rk, rv, 4, ctx=CPU)
    obs_spans.reset()
    obs_metrics.reset()
    try:
        with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                             CYLON_TPU_RETRY_MAX="0",
                             CYLON_TPU_TRACE="1"):
            # run 1 journals its first pass, then dies of a persistent
            # transient with the retry budget at zero
            with resilience.fault_plan("host_fetch@2+=comm"):
                with pytest.raises(Exception):
                    chunked_join_groupby(lk, lv, rk, rv, 4, ctx=CPU)
            obs_spans.reset()
            obs_metrics.reset()
            res, stats = chunked_join_groupby(lk, lv, rk, rv, 4, ctx=CPU)
        assert stats["passes_skipped"] == 1
        assert stats["parts_run"] == base_stats["passes"] - 1
        by_name = {}
        for e in obs_spans.events():
            by_name.setdefault(e.name, []).append(e)
        assert len(by_name["durable.resume"]) == 1
        assert by_name["durable.resume"][0].attrs["journaled_passes"] == 1
        skipped = by_name["durable.pass_skipped"]
        assert [e.attrs["part"] for e in skipped] == [0]
        assert skipped[0].attrs["rows"] >= 0
        counters = obs_metrics.snapshot()["counters"]
        assert counters["durable.passes_skipped"] == 1
        assert counters["durable.resumes"] == 1
        assert counters["exec.parts_run"] == stats["parts_run"]
        _assert_bit_identical(res, base)
    finally:
        obs_spans.reset()
        obs_metrics.reset()


def test_record_pass_refuses_a_tensor_column(tmp_path):
    """A frame column that is not host numpy is the caller's bug: it
    raises instead of passing for a spill failure that turns the journal
    off."""
    import torch

    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j = durable.open_run("d" * 64, "test")
        with pytest.raises(TypeError, match="not host numpy"):
            j.record_pass(0, 0, {"x": torch.arange(3)}, 3)
        assert j.record_pass(0, 0, {"x": np.arange(3)}, 3)


# ---------------------------------------------------------------------------
# across the two packages: spills, manifests and loads
# ---------------------------------------------------------------------------

def _mixed_frame(n=40):
    rng = np.random.default_rng(3)
    return {"i64": rng.integers(-2**40, 2**40, n).astype(np.int64),
            "i32": rng.integers(-9, 9, n).astype(np.int32),
            "f32": rng.random(n).astype(np.float32),
            "f64": np.where(np.arange(n) % 7 == 0, np.nan,
                            rng.standard_normal(n)),
            "b": rng.random(n) < 0.5,
            "s": np.array([None if i % 5 == 0 else f"row{i}"
                           for i in range(n)], object)}


def test_spill_bytes_and_manifest_identical_across_packages(tmp_path):
    """The same frame journaled by either package gives the same spill
    bytes, the same sha256 and the same manifest, line for line."""
    from cylon_tpu.io import arrow_io as rarrow_io

    frame = _mixed_frame()
    payload = arrow_io.frame_to_ipc_bytes(frame)
    assert payload == rarrow_io.frame_to_ipc_bytes(frame)
    fp = "c" * 64
    for pkg, name in ((durable, "port"), (rdurable, "ref")):
        with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / name)):
            j = pkg.open_run(fp, "test")
            assert j.record_pass(0, 0, frame, len(frame["i64"]))
            j.record_done(1, len(frame["i64"]))
    port_dir, ref_dir = tmp_path / "port" / fp, tmp_path / "ref" / fp
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    spill = "pass_L0_P0.arrow"
    assert (port_dir / spill).read_bytes() == (ref_dir / spill).read_bytes()
    assert (port_dir / spill).read_bytes() == payload
    assert (port_dir / durable.MANIFEST).read_bytes() == \
        (ref_dir / durable.MANIFEST).read_bytes()
    entry = json.loads((port_dir / durable.MANIFEST).read_text()
                       .splitlines()[1])
    import hashlib

    assert entry["sha256"] == hashlib.sha256(payload).hexdigest()
    assert durable.run_digest(str(port_dir))["digest"] == \
        rdurable.run_digest(str(ref_dir))["digest"]


def _run_dir(root):
    (d,) = [n for n in os.listdir(root)
            if os.path.isdir(os.path.join(root, n))]
    return d


def _load_all(pkg, root, fp, passes):
    """Every pass of a journaled run, loaded by ``pkg``'s RunJournal."""
    j = pkg.RunJournal(str(root), fp, "join_groupby")
    j._open()
    assert j.is_complete() and j.completed_count() == passes
    frames = [j.load_pass(0, p) for p in range(passes)]
    assert all(f is not None for f in frames)
    return {k: np.concatenate([f[0][k] for f in frames])
            for k in frames[0][0]}


@pytest.mark.fault
def test_each_package_loads_a_run_the_other_wrote(rng, tmp_path,
                                                  no_live_journal):
    """A journaled engine run of either package is a journal the other
    package's ``RunJournal`` opens and loads pass for pass, bit for bit
    (the fingerprints differ, so each side opens the writer's run dir by
    name)."""
    left, right = _join_inputs(rng, n=1500)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        got, gstats = _run(left, right, passes=3)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "ref")):
        want, wstats = rexec.chunked_join_groupby_tables(
            left, right, on="k", how="inner", group_by="l_k",
            agg={"a": ["sum"], "b": ["mean"]}, passes=3, mode="hash")
    assert gstats["passes"] == wstats["passes"] == 3
    port_fp = _run_dir(tmp_path / "port")
    ref_fp = _run_dir(tmp_path / "ref")
    _assert_bit_identical(
        _load_all(rdurable, tmp_path / "port", port_fp, 3), got)
    _assert_bit_identical(
        _load_all(durable, tmp_path / "ref", ref_fp, 3), want)


@pytest.mark.fault
def test_journaled_port_engine_equals_reference_unjournaled(rng, tmp_path):
    """One journaled port engine run, and its full journal hit, equal the
    reference's unjournaled ``chunked_join_groupby_tables`` row for row
    (float32 within rtol 1e-5)."""
    left, right = _join_inputs(rng, n=2000)
    want, _ = rexec.chunked_join_groupby_tables(
        left, right, on="k", how="inner", group_by="l_k",
        agg={"a": ["sum"], "b": ["mean"]}, passes=4, mode="hash")
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        got, s1 = _run(left, right)
        hit, s2 = _run(left, right)
    assert s1["passes_skipped"] == 0 and s2["passes_skipped"] == 4
    assert_frames_equal(got, want)
    _assert_bit_identical(hit, got)


@pytest.mark.fault
def test_rejected_pass_reexecutes_alone(rng, tmp_path, monkeypatch):
    """A journaled run whose middle spill fails its checksum reloads the
    other passes and sizes, warms and runs its level over the rejected
    pass alone: one exact-sizing count, one executed part, bit for bit."""
    from cylon_tpu_torch import exec as pexec

    left, right = _join_inputs(rng)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        base, _ = _run(left, right)
        (fp,) = os.listdir(tmp_path)
        _flip_byte(tmp_path / fp / "pass_L0_P2.arrow")
        sized = []
        count = pexec.join_mod.join_row_count
        monkeypatch.setattr(pexec.join_mod, "join_row_count",
                            lambda *a, **k: sized.append(1) or count(*a, **k))
        res, stats = _run(left, right)
    assert (stats["passes_skipped"], stats["parts_run"]) == (3, 1)
    assert len(sized) == 1
    _assert_bit_identical(res, base)


@pytest.mark.fault
def test_oneshot_fallback_is_journaled(rng, tmp_path):
    """Under a durable dir the one-shot join's OOM fallback rides the
    journaled engine: its instant says so, a run dir is written, and the
    rows equal the one-shot join's."""
    from cylon_tpu_torch import Table

    left, right = _join_inputs(rng, n=600)
    lt = Table.from_numpy(list(left), list(left.values()), ctx=CPU)
    rt = Table.from_numpy(list(right), list(right.values()), ctx=CPU)
    base = lt.join(rt, on="k").to_numpy()
    obs_spans.reset()
    try:
        with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                             CYLON_TPU_TRACE="1"):
            with resilience.fault_plan("oneshot_join@1=oom"):
                got = lt.join(rt, on="k").to_numpy()
        fallback = [e.attrs for e in obs_spans.events()
                    if e.name == "table.oneshot_fallback"]
    finally:
        obs_spans.reset()
    assert fallback == [{"durable": True}]
    assert len(durable.scan_runs(str(tmp_path))) == 1
    order = lambda f: np.lexsort((f["a"], f["b"], f["l_k"]))  # noqa: E731
    for k in base:
        np.testing.assert_array_equal(got[k][order(got)],
                                      base[k][order(base)], err_msg=k)


def test_coordinator_journal_reply_placement():
    """The anti-entropy placement math, unit-level: guards only
    load-bearing copies (holders < RF), assigns exactly RF - holders
    pullers deterministically, counts DISTINCT roots (shared-filesystem
    replicas are one copy), and goes quiet at RF=1."""
    from cylon_tpu_torch import elastic

    coord = elastic.Coordinator(world=3)
    fp = "a" * 64
    rec = {"digest": "d1", "complete": True, "pinned": False,
           "passes": 2, "bytes": 100}
    coord._last_hb = {0: 0.0, 1: 0.0, 2: 0.0}
    coord._telemetry = {
        0: {"journal": {"addr": ["h0", 1], "root": "/r0",
                        "digests": {fp: rec}}},
        1: {"journal": {"addr": ["h1", 2], "root": "/r1", "digests": {}}},
        2: {"journal": {"addr": ["h2", 3], "root": "/r2", "digests": {}}},
    }
    with config.knob_env(CYLON_TPU_DURABLE_RF="2"):
        holder = coord._journal_reply_locked(0)
        puller = coord._journal_reply_locked(1)
        spare = coord._journal_reply_locked(2)
    # the only copy is load-bearing: guarded on the holder, hinted to
    # exactly the FIRST non-holder rank, nothing for the spare
    assert holder["journal_guard"] == [fp]
    assert "journal_sync" not in holder
    assert puller["journal_sync"] == [
        {"fingerprint": fp, "from": ["h0", 1], "pinned": False}]
    assert "journal_sync" not in spare and "journal_guard" not in spare
    assert set(puller["journal_peers"]) == {"0", "2"}
    # rank 1 now holds a copy too: replicated to target -> no guard, no
    # hints, GC free to evict either copy
    coord._telemetry[1]["journal"]["digests"] = {fp: dict(rec)}
    with config.knob_env(CYLON_TPU_DURABLE_RF="2"):
        assert "journal_guard" not in coord._journal_reply_locked(0)
        assert "journal_sync" not in coord._journal_reply_locked(2)
    # shared root: two ranks advertising ONE realpath are one copy
    coord._telemetry[1]["journal"]["root"] = "/r0"
    with config.knob_env(CYLON_TPU_DURABLE_RF="2"):
        assert coord._journal_reply_locked(0)["journal_guard"] == [fp]
        assert coord._journal_reply_locked(2)["journal_sync"][0][
            "fingerprint"] == fp
    # RF=1: anti-entropy off — no guards, no hints, ever
    with config.knob_env(CYLON_TPU_DURABLE_RF="1"):
        r0 = coord._journal_reply_locked(0)
        assert "journal_guard" not in r0 and "journal_sync" not in r0
    # a dead rank's advertisement stops counting
    coord._telemetry[1]["journal"]["root"] = "/r1"
    coord._telemetry[1]["journal"]["digests"] = {}
    coord._dead[1] = "fenced"
    with config.knob_env(CYLON_TPU_DURABLE_RF="2"):
        assert set(coord._journal_reply_locked(0)["journal_peers"]) == {"2"}


def test_fleet_anti_entropy_converges(tmp_path, no_live_journal):
    """The tentpole, in-process: two replicas with DISTINCT journal
    roots heartbeat a real coordinator; the run only root 0 holds is
    hinted to root 1 over the beats and arrives complete, loadable and
    bit-identical — no direct wiring between the replicas."""
    from cylon_tpu_torch import elastic

    roots = [tmp_path / "r0", tmp_path / "r1"]
    frame = _mk_run(roots[0], fp="a" * 64)
    os.makedirs(roots[1], exist_ok=True)
    coord = elastic.Coordinator(world=2, heartbeat_timeout_s=2.0).start()
    addr = f"{coord.address[0]}:{coord.address[1]}"
    servers, syncers, agents = [], [], []
    try:
        for r in range(2):
            srv = durable_sync.JournalPeerServer(str(roots[r]))
            sy = durable_sync.JournalSyncer(str(roots[r]))
            a = elastic.Agent(addr, r, interval_s=0.05, timeout_s=2.0)

            def tel(sy=sy, srv=srv):
                j = sy.telemetry()
                j["addr"] = list(srv.address)
                return {"journal": j}

            a.attach_telemetry(tel)
            a.attach_journal_sync(sy.on_heartbeat)
            a.start()
            servers.append(srv)
            syncers.append(sy)
            agents.append(a)
        deadline = time.time() + 30
        target = roots[1] / ("a" * 64) / durable.MANIFEST
        while time.time() < deadline and not os.path.exists(target):
            time.sleep(0.05)
        assert os.path.exists(target), "anti-entropy never converged"
        # while under-replicated the holder's GC guard was installed;
        # after convergence the run loads bit-identical from root 1
        with config.knob_env(CYLON_TPU_DURABLE_DIR=str(roots[1])):
            j = durable.open_run("a" * 64, "test")
            assert j.completed_count() == 2
            loaded, rows = j.load_pass(0, 0)
        _assert_bit_identical(loaded, frame)
    finally:
        for a in agents:
            a.stop()
        for s in syncers:
            s.close()
        for s in servers:
            s.close()
        coord.stop()
    assert durable._REPLICATION_GUARD is None, "syncer close left a guard"


def test_journal_syncer_takes_heartbeat_json(tmp_path, no_live_journal,
                                             peerless):
    """``JournalSyncer.on_heartbeat`` takes a coordinator's reply as plain
    JSON: ``journal_peers`` becomes the read-repair registry,
    ``journal_guard`` the GC replication guard, and each
    ``journal_sync`` hint a pull on the syncer's own thread; ``close``
    clears the guard and the peers.  (``elastic.Coordinator`` sends these
    replies: ``test_fleet_anti_entropy_converges``.)"""
    src, dst = tmp_path / "src", tmp_path / "dst"
    frame = _mk_run(src, fp="a" * 64)
    os.makedirs(dst)
    srv = durable_sync.JournalPeerServer(str(src))
    sy = durable_sync.JournalSyncer(str(dst))
    try:
        assert sy.telemetry() == {"root": os.path.realpath(str(dst)),
                                  "digests": {}}
        sy.on_heartbeat(json.loads(json.dumps({
            "journal_peers": {"0": list(srv.address)},
            "journal_guard": ["b" * 64],
            "journal_sync": [{"fingerprint": "a" * 64,
                              "from": list(srv.address), "pinned": False},
                             {"fingerprint": "bad"}]})))
        assert durable_sync.peers() == (tuple(srv.address),)
        assert durable._REPLICATION_GUARD("b" * 64)
        assert not durable._REPLICATION_GUARD("a" * 64)
        target = dst / ("a" * 64) / durable.MANIFEST
        deadline = time.time() + 30
        while time.time() < deadline and not target.exists():
            time.sleep(0.02)
        assert target.exists(), "the hinted pull never landed"
        assert set(sy.telemetry()["digests"]) == {"a" * 64}
    finally:
        sy.close()
        srv.close()
    assert durable._REPLICATION_GUARD is None
    assert durable_sync.peers() == ()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(dst)):
        loaded, _ = durable.open_run("a" * 64, "test").load_pass(0, 1)
    _assert_bit_identical(loaded, frame)


def test_scrubber_thread_scrubs_on_its_interval(tmp_path, no_live_journal,
                                                peerless):
    """``Scrubber`` runs ``scrub_once`` every ``CYLON_TPU_SCRUB_S``: a
    bitrotted run is quarantined without a call, and ``close`` stops the
    thread; at 0 (the default) it never starts."""
    _mk_run(tmp_path)
    durable._LAST_JOURNAL = None  # _mk_run left its run live
    _flip_byte(tmp_path / ("f" * 64) / "pass_L0_P0.arrow")
    with config.knob_env(CYLON_TPU_SCRUB_S="0"):
        idle = durable_sync.Scrubber(str(tmp_path)).start()
    assert not idle._thread.is_alive()
    with config.knob_env(CYLON_TPU_SCRUB_S="0.05"):
        sc = durable_sync.Scrubber(str(tmp_path)).start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline and durable.scan_runs(str(tmp_path)):
            time.sleep(0.02)
    finally:
        sc.close()
    assert durable.scan_runs(str(tmp_path)) == []
    assert not sc._thread.is_alive()


# ---------------------------------------------------------------------------
# the transport and the wire codec the journal's peers ride
# ---------------------------------------------------------------------------

def test_wire_codec_matches_reference():
    """Frames, arrays and scalars encode to the reference's JSON tree
    (the same Arrow IPC bytes), so ``request_key`` agrees across the
    packages; decoding is bit-exact; classified errors cross the wire
    with their code and retry-after hint."""
    from cylon_tpu.router import wire as rwire
    from cylon_tpu_torch.router import wire

    frame = _mixed_frame()
    payload = wire.encode_payload(
        (frame, np.arange(5, dtype=np.int32), np.float32(2.5)),
        {"on": "k", "n": 3, "opts": {"x": [1, None]}})
    want = rwire.encode_payload(
        (frame, np.arange(5, dtype=np.int32), np.float32(2.5)),
        {"on": "k", "n": 3, "opts": {"x": [1, None]}})
    assert payload == want
    assert wire.request_key("join", payload) == \
        rwire.request_key("join", want)
    assert wire.payload_nbytes(payload) == rwire.payload_nbytes(want)
    args, kwargs = wire.decode_payload(json.loads(json.dumps(payload)))
    assert_frames_equal(args[0], frame)
    assert args[1].dtype == np.int32 and args[2] == 2.5
    assert kwargs == {"n": 3, "on": "k", "opts": {"x": [1, None]}}
    with pytest.raises(CylonError) as e:
        wire.encode_value(object())
    assert e.value.code == Code.SerializationError
    err = wire.classified_error(wire.classified(
        CylonError(Code.ResourceExhausted, "full", retry_after_s=1.5)))
    assert (err.code, err.msg, err.retry_after_s) == \
        (Code.ResourceExhausted, "full", 1.5)
    assert wire.classified_error({"code": "Nope"}).code == Code.UnknownError
    assert wire.jsonable({"a": np.int64(3), "b": {2, 1}}) == \
        {"a": 3, "b": ["1", "2"]}


def test_control_server_round_trip_and_line_cap():
    """``JsonServer`` answers one JSON line per connection (a handler
    exception becomes ``{"ok": false}``), ``request`` carries the active
    trace context, and a reply past ``max_line`` is a ``ProtocolError``."""
    from cylon_tpu_torch.net import control
    from cylon_tpu_torch.obs import tracectx

    seen = []

    def handler(req):
        seen.append(req)
        if req.get("cmd") == "boom":
            raise ValueError("bad verb")
        return {"ok": True, "echo": req.get("x"), "pad": "y" * req.get("n", 0)}

    srv = control.JsonServer(handler).start()
    try:
        assert control.request(srv.address, {"x": 7}) == \
            {"ok": True, "echo": 7, "pad": ""}
        bad = control.request(srv.address, {"cmd": "boom"})
        assert bad["ok"] is False and "bad verb" in bad["error"]
        ctx = tracectx.TraceContext("a" * 32, "b" * 16, None, True)
        with tracectx.activate(ctx):
            control.request(srv.address, {"x": 1})
        assert seen[-1]["traceparent"] == ctx.traceparent()
        assert tracectx.parse_or_none(seen[-1]["traceparent"]) == ctx
        with pytest.raises(control.ProtocolError):
            control.request(srv.address, {"n": 5000}, max_line=1024)
    finally:
        srv.close()
