"""The port's resilience layer and the host modules the out-of-core engine
reads (``status.Status``, ``resilience``, ``durable``'s pass deadlines,
``config``'s knobs, ``obs``) against the JAX package's copies on the same
inputs: fault-plan parsing and firing, retry backoff, and error
classification, a ``torch.OutOfMemoryError`` included.  All exact."""
import json
import os
import time

import numpy as np
import pytest
import torch

from cylon_tpu import config as rconfig
from cylon_tpu import resilience as rres
from cylon_tpu.obs import export as rexport
from cylon_tpu.status import CylonError as RCylonError
from cylon_tpu.status import Status as RStatus
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import durable
from cylon_tpu_torch import resilience as pres
from cylon_tpu_torch.obs import fleet, metrics, spans
from cylon_tpu_torch.status import Code, CylonError, Status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ["pass_dispatch", "pass_dispatch@2=oom", "host_fetch@3+=comm",
         "a@1=timeout;b@2=unknown,c@4+=oom", "seed=7;x@2~3=comm;y@1~5=oom",
         "pass_dispatch@2=hang;host_fetch@1=delay", " s @ 1 = OOM ;; "]
BAD_SPECS = ["x=nosuchkind", "x@0", "x@two", "@1=oom", "seed=abc",
             "x@1~-1=oom", "x@1~z=oom"]


def _rules(plan):
    return [(r.site, r.nth, r.kind, r.persistent) for r in plan.rules]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_the_reference(spec):
    got, want = pres.FaultPlan.parse(spec), rres.FaultPlan.parse(spec)
    assert _rules(got) == _rules(want)
    assert got.seed == want.seed
    sites = [r.site for r in got.rules] * 6
    assert [got.check(s) for s in sites] == [want.check(s) for s in sites]
    assert got.fired == want.fired and got.hits == want.hits


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_plans_raise_invalid_in_both(spec):
    with pytest.raises(CylonError) as e:
        pres.FaultPlan.parse(spec)
    assert e.value.code == Code.Invalid
    with pytest.raises(RCylonError):
        rres.FaultPlan.parse(spec)


@pytest.mark.parametrize("kind", ["oom", "timeout", "comm", "unknown"])
def test_fault_point_raises_and_classifies_as_the_reference(kind):
    caught = []
    for mod in (pres, rres):
        with mod.fault_plan(f"site@2={kind}") as plan:
            mod.fault_point("site")  # hit 1: nothing
            with pytest.raises(mod.InjectedFault) as e:
                mod.fault_point("site")
            assert plan.fired == [("site", kind, 2)]
        caught.append(e.value)
    assert str(caught[0]) == str(caught[1])
    assert pres.classify(caught[0]).name == rres.classify(caught[1]).name


def test_env_fault_plan_and_journal_kinds():
    with pconfig.knob_env(CYLON_TPU_FAULT_PLAN="s@1=oom"):
        with pytest.raises(pres.InjectedFault, match="RESOURCE_EXHAUSTED"):
            pres.fault_point("s")
        pres.fault_point("s")  # hit 2: nothing
    pres.fault_point("s")  # no plan: a no-op
    # the journal's kinds parse as the reference's do (they act in
    # test_journal_fault_kinds_act)
    for kind in ("journal_corrupt", "bitrot", "cache_evict_race"):
        spec = f"j@1={kind}"
        assert _rules(pres.FaultPlan.parse(spec)) == \
            _rules(rres.FaultPlan.parse(spec))
    with pres.fault_plan("d@1=delay") as plan:
        t0 = time.perf_counter()
        pres.fault_point("d")  # sleeps, raises nothing
        assert time.perf_counter() - t0 >= pres.fault_delay_s()
    assert plan.fired == [("d", "delay", 1)]


@pytest.mark.parametrize("kind", ["delay", "coord_slow", "replica_sick"])
def test_fault_delay_knob_drives_the_sleeping_kinds(kind):
    """``CYLON_TPU_FAULT_DELAY_S`` (read per hit, so a worker's
    environment sets it) is how long the three sleeping kinds stall
    their probe before it continues; both packages read it alike."""
    with pconfig.knob_env(CYLON_TPU_FAULT_DELAY_S="0.05"):
        assert pres.fault_delay_s() == rres.fault_delay_s() == 0.05
        with pres.fault_plan(f"s@1={kind}") as plan:
            t0 = time.perf_counter()
            pres.fault_point("s")
            assert time.perf_counter() - t0 >= 0.05
        assert plan.fired == [("s", kind, 1)]
    with pconfig.knob_env(CYLON_TPU_FAULT_DELAY_S="-1"):
        assert pres.fault_delay_s() == 0.0


@pytest.mark.parametrize("kind", ["coord_partition", "coord_slow",
                                  "coordinator_loss", "coordinator_restart",
                                  "heartbeat_loss", "rank_kill",
                                  "replica_sick"])
def test_unported_fault_kinds_are_refused(kind):
    """The gang's, the control plane's and the router's kinds parse as
    the reference's do, with its messages; an unknown kind is still
    refused, classified Invalid."""
    spec = f"pass_dispatch@2+={kind}"
    assert _rules(pres.FaultPlan.parse(spec)) == \
        _rules(rres.FaultPlan.parse(spec))
    assert pres._KIND_MESSAGES[kind] == rres._KIND_MESSAGES[kind]
    with pytest.raises(CylonError) as e:
        pres.FaultPlan.parse(f"pass_dispatch@1={kind}x")
    assert e.value.code == Code.Invalid


@pytest.mark.parametrize("jitter,seed", [("none", 0), ("full", 0),
                                         ("full", 12345)])
def test_retry_policy_delays_match_reference(jitter, seed):
    kw = dict(max_retries=5, base_s=0.01, max_s=0.3, jitter=jitter,
              jitter_seed=seed)
    got, want = pres.RetryPolicy(**kw), rres.RetryPolicy(**kw)
    idx = [0, 1, 2, 3, 10, 63, 64, 200]
    assert [got.delay(i) for i in idx] == [want.delay(i) for i in idx]
    assert list(got.delays()) == list(want.delays())


def test_retry_policy_from_env_reads_the_knobs():
    env = dict(CYLON_TPU_RETRY_MAX="5", CYLON_TPU_RETRY_BASE_S="0.5",
               CYLON_TPU_RETRY_MAX_S="9")
    with pconfig.knob_env(**env), rconfig.knob_env(**env):
        got, want = pres.RetryPolicy.from_env(), rres.RetryPolicy.from_env()
    assert (got.max_retries, got.base_s, got.max_s) \
        == (want.max_retries, want.base_s, want.max_s) == (5, 0.5, 9.0)
    with pconfig.knob_env(CYLON_TPU_MAX_OOM_SPLITS="7"):
        assert pres.max_oom_splits() == 7
    assert pres.max_oom_splits() == 4


def _exceptions():
    return [
        torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                               "2.00 GiB (GPU 0; 79.11 GiB total capacity)"),
        RuntimeError("CUDA error: out of memory"),
        RuntimeError("RESOURCE_EXHAUSTED: attempting to allocate"),
        MemoryError("host"),
        TimeoutError("slow"),
        ConnectionResetError("peer"),
        RuntimeError("DEADLINE_EXCEEDED: operation timed out"),
        RuntimeError("UNAVAILABLE: connection reset by peer"),
        RuntimeError("INTERNAL: something else"),
        ValueError("the operation timed out"),  # a bug's wording
        TypeError("out of memory"),             # ditto
        KeyError("x"),
    ]


@pytest.mark.parametrize("i", range(12))
def test_status_from_exception_matches_reference(i):
    exc = _exceptions()[i]
    got, want = Status.from_exception(exc), RStatus.from_exception(exc)
    assert got.code.name == want.code.name
    assert got.msg == want.msg
    assert bool(got) is False and got.get_code() == got.code


def test_status_classifies_cuda_allocator_failures_as_oom():
    """By type (``torch.OutOfMemoryError``, whatever its text), and by the
    CUDA runtime's error name when a library surfaces the failure as a
    plain RuntimeError; a CylonError keeps its own code."""
    assert Status.from_exception(torch.OutOfMemoryError("x")).code \
        == Code.OutOfMemory
    e = RuntimeError("CUDA error: cudaErrorMemoryAllocation during launch")
    assert Status.from_exception(e).code == Code.OutOfMemory
    assert Status.from_exception(CylonError(Code.Timeout, "t")) \
        == Status(Code.Timeout, "t")
    assert Status.OK().is_ok() and bool(Status.OK())


def test_knobs_keep_the_reference_names_and_defaults():
    for name, k in pconfig.KNOBS.items():
        ref = rconfig.KNOBS[name]
        assert (k.kind, k.default) == (ref.kind, ref.default), name
        if k.kind == "enum":
            assert set(k.choices) == set(ref.choices), name
    with pconfig.knob_env(CYLON_TPU_PREFETCH="off",
                          CYLON_TPU_MAX_OOM_SPLITS="x",
                          CYLON_TPU_RETRY_BASE_S="0.25",
                          CYLON_TPU_ACCUM="bogus"):
        assert pconfig.knob("CYLON_TPU_PREFETCH") is False
        assert pconfig.knob("CYLON_TPU_MAX_OOM_SPLITS") == 4  # default
        assert pconfig.knob("CYLON_TPU_RETRY_BASE_S") == 0.25
        assert pconfig.knob("CYLON_TPU_ACCUM") == "auto"
    assert os.environ.get("CYLON_TPU_PREFETCH") is None
    with pytest.raises(KeyError):
        pconfig.knob_raw("CYLON_TPU_NOT_A_KNOB")


def test_pass_deadline_fires_and_classifies_timeout():
    assert durable.pass_deadline() is durable.pass_deadline()  # shared no-op
    with pconfig.knob_env(CYLON_TPU_PASS_DEADLINE_S="0.01"):
        d = durable.pass_deadline("site")
        with d:
            time.sleep(0.1)
        with pytest.raises(CylonError) as e:
            d.raise_if_fired()
        assert e.value.code == Code.Timeout
        d.accept_late()  # records, never raises
    with pconfig.knob_env(CYLON_TPU_QUARANTINE_AFTER="3"):
        assert durable.quarantine_after() == 3


def test_durable_dir_opens_a_journal(tmp_path):
    """``CYLON_TPU_DURABLE_DIR`` set: ``open_run`` opens a run dir under
    it and writes the manifest header; unset, nothing is journaled."""
    assert not durable.enabled() and durable.open_run("a" * 64, "t") is None
    with pconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        assert durable.enabled()
        j = durable.open_run("a" * 64, "t")
    assert os.listdir(tmp_path) == ["a" * 64]
    header = json.loads((tmp_path / ("a" * 64) / durable.MANIFEST)
                        .read_text())
    assert header == {"kind": "run", "fingerprint": "a" * 64, "op": "t"}
    assert j.completed_count() == 0 and not j.is_complete()


_KILL_SRC = """\
from cylon_tpu_torch import resilience
resilience.fault_point("site")
print("survived")
"""


@pytest.mark.fault
@pytest.mark.parametrize("kind", ["killhard", "sync_partial",
                                  "journal_corrupt", "bitrot",
                                  "cache_evict_race", "disk_full"])
def test_journal_fault_kinds_act(kind, tmp_path, monkeypatch):
    """Each of the journal's fault kinds does what the reference's does:
    killhard and sync_partial end the process with rc 137 at the probe,
    journal_corrupt truncates the last committed spill to half, bitrot
    flips one mid-file byte of one spill, cache_evict_race deletes the
    run's spills and keeps its manifest, disk_full raises ENOSPC (with the
    reference's message)."""
    import errno
    import subprocess
    import sys

    if kind in ("killhard", "sync_partial"):
        env = dict(os.environ, CYLON_TPU_FAULT_PLAN=f"site@1={kind}",
                   PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", _KILL_SRC], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 137, out.stderr[-2000:]
        assert "survived" not in out.stdout
        return
    monkeypatch.setattr(durable, "_LAST_JOURNAL", None)
    frame = {"k": np.arange(64, dtype=np.int64)}
    with pconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j = durable.open_run("b" * 64, "t")
        for p in range(2):
            assert j.record_pass(0, p, frame, 64)
    run = tmp_path / ("b" * 64)
    paths = [run / f"pass_L0_P{p}.arrow" for p in (0, 1)]
    before = [p.read_bytes() for p in paths]
    with pres.fault_plan(f"site@1={kind}") as plan:
        if kind == "disk_full":
            with pytest.raises(OSError) as e:
                pres.fault_point("site")
            assert e.value.errno == errno.ENOSPC
            with rres.fault_plan(f"site@1={kind}"):
                with pytest.raises(OSError) as want:
                    rres.fault_point("site")
            assert str(e.value) == str(want.value)
        else:
            pres.fault_point("site")
    assert plan.fired == [("site", kind, 1)]
    if kind == "cache_evict_race":
        assert os.listdir(run) == [durable.MANIFEST]
        good = [False, False]
    else:
        after = [p.read_bytes() for p in paths]
        good = [a == b for a, b in zip(after, before)]
        if kind == "journal_corrupt":  # the last committed spill, halved
            assert after[1] == before[1][:len(before[1]) // 2]
        elif kind == "bitrot":  # one mid-file byte of one spill, flipped
            (bad,) = [i for i in (0, 1) if not good[i]]
            diff = [i for i, (x, y) in enumerate(zip(after[bad],
                                                     before[bad])) if x != y]
            assert diff == [len(before[bad]) // 2]
            assert len(after[bad]) == len(before[bad])
        else:  # disk_full touches no file
            assert good == [True, True]
    assert good.count(False) == {"journal_corrupt": 1, "bitrot": 1,
                                 "cache_evict_race": 2, "disk_full": 0}[kind]
    with pconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        j2 = durable.open_run("b" * 64, "t")
        assert [j2.load_pass(0, p) is not None for p in (0, 1)] == good


def test_obs_watermark_spans_and_flight_record(tmp_path):
    metrics.reset()
    spans.reset()
    assert metrics.record_hbm_watermark("cpu") == 0
    assert metrics.snapshot()["gauges"]["hbm.live_bytes"] == 0.0
    with pconfig.knob_env(CYLON_TPU_TRACE="1",
                          CYLON_TPU_TRACE_DIR=str(tmp_path)):
        with spans.span("exec.pass", part=0) as sp:
            sp.set(rows=3)
        spans.instant("exec.oom_split", level=1)
        metrics.counter_add("oom.refinements")
        path = fleet.flight_record("pass_fatal", run_id="r1",
                                   code="OutOfMemory")
    ev = spans.events()
    assert [e.name for e in ev] == ["exec.pass", "exec.oom_split",
                                    "flight.dump"]
    assert ev[0].attrs == {"part": 0, "rows": 3}
    doc = fleet.load_flight(path)
    assert os.path.basename(path) == "r1.r0.json"
    assert doc["reason"] == "pass_fatal"
    assert doc["metrics"]["counters"]["oom.refinements"] == 1
    assert [e["name"] for e in doc["traceEvents"]][:2] \
        == ["exec.pass", "exec.oom_split"]
    # the Chrome-trace form of an event is the reference exporter's
    assert json.dumps(fleet._event_json(ev[0], 0), sort_keys=True) == \
        json.dumps(rexport._event_json(ev[0], 0), sort_keys=True)
    spans.reset()
    metrics.reset()
    fleet.reset()


def test_obs_off_mode_is_a_no_op():
    spans.reset()
    with pconfig.knob_env(CYLON_TPU_TRACE="0"):
        assert spans.span("x") is spans.span("y")
        with spans.span("x"):
            pass
        spans.instant("y")
    assert spans.aggregate_report() == {} and spans.events() == ()
    assert np.isclose(metrics.counter_value("nothing"), 0)
