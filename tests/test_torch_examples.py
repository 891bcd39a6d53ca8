"""The BASELINE example drivers on the port (``cylon_tpu_torch/examples``)
against the JAX package's (``examples/``): the twins of the 12 cases of
``tests/test_examples.py``, at the same sizes, on the CPU.

Each case runs the reference driver on 4 shards (``world=4``; the
scaling sweep on every device) and the port's driver on a 4-shard CPU
mesh (``world=4, device="cpu"``) from the same seed, and compares what
they computed: each driver's result frame is read back by wrapping the
packages' ``Table.to_pandas`` / ``to_numpy`` / ``shuffle`` (or the
engine call) for the one run.  Both drivers also run their own pandas
checks (``check=True``).

Tolerances: keys, counts, row counts and CSV bytes exact; float sums
within rtol 1e-5 (Q1, whose driver checks at 1e-5) or 1e-4 (Q3, Q5, Q6,
Q10: the drivers' own pandas checks' tolerance); the ETL features within
rtol 1e-6, and its per-step losses, from the reference's Flax weights
carried across by ``params_from_flax``, within rtol 1e-4 of optax's
Adam(1e-3).
"""
import contextlib
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import cylon_tpu
import cylon_tpu_torch
from cylon_tpu_torch import CylonContext, MeshConfig
from cylon_tpu_torch.examples import (etl_to_torch, join_csv, scaling,
                                      shuffle_bench, tpch_data, tpch_q1,
                                      tpch_q3, tpch_q5, tpch_q6, tpch_q10)
from examples import etl_to_flax as ref_etl
from examples import join_csv as ref_join_csv
from examples import scaling as ref_scaling
from examples import shuffle_bench as ref_shuffle
from examples import tpch_data as ref_tpch_data
from examples import tpch_q1 as ref_q1
from examples import tpch_q3 as ref_q3
from examples import tpch_q5 as ref_q5
from examples import tpch_q6 as ref_q6
from examples import tpch_q10 as ref_q10

PORT = dict(world=4, device="cpu")
REF = dict(world=4)


@pytest.fixture(scope="module")
def mesh4():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


def _returns(monkeypatch, owner, name):
    """Wrap ``owner.name`` for this test; the list collects what each call
    returned."""
    got = []
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        got.append(out)
        return out

    monkeypatch.setattr(owner, name, wrapped)
    return got


def _frames(monkeypatch, name="to_pandas"):
    """(port results, reference results) of ``Table.<name>``."""
    return (_returns(monkeypatch, cylon_tpu_torch.Table, name),
            _returns(monkeypatch, cylon_tpu.Table, name))


def _same_keys(got, want, keys):
    assert len(got) == len(want)
    for k in keys:
        assert list(got[k]) == list(want[k]), k


def _close(got, want, cols, rtol):
    for c in cols:
        np.testing.assert_allclose(np.asarray(got[c], np.float64),
                                   np.asarray(want[c], np.float64),
                                   rtol=rtol, err_msg=c)


# -- tpch_data ---------------------------------------------------------------

DRAWS = [("lineitem", (0.002,), {}),
         ("lineitem", (0.002,), {"q5_keys": True}),
         ("lineitem", (0.002,), {"q5_keys": True, "orders_rows": 1234}),
         ("orders", (0.002,), {}), ("orders", (0.002,), {"q3_cols": True}),
         ("customer", (0.01,), {}), ("customer", (0.01,), {"q3_cols": True}),
         ("supplier", (0.1,), {}), ("nation", (), {}), ("region", (), {})]


@pytest.mark.parametrize("fn,args,flags", DRAWS,
                         ids=[f"{f}-{'-'.join(k) or 'plain'}"
                              for f, _, k in DRAWS])
def test_tpch_data_draws_the_references_arrays(fn, args, flags):
    rng = (np.random.default_rng(7),) if args else ()
    ref_rng = (np.random.default_rng(7),) if args else ()
    got = getattr(tpch_data, fn)(*args, *rng, **flags)
    want = getattr(ref_tpch_data, fn)(*args, *ref_rng, **flags)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if rng:  # both generators advanced alike
        assert rng[0].random() == ref_rng[0].random()


def test_tpch_data_constants_are_the_references():
    names = [n for n in dir(ref_tpch_data) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tpch_data, n) == getattr(ref_tpch_data, n), n


# -- the drivers -------------------------------------------------------------

def _fixed_tempdir(monkeypatch, module, path):
    """``module.tempfile.TemporaryDirectory()`` yields ``path`` and keeps
    it, so a test can read what the driver wrote there."""
    path.mkdir()
    monkeypatch.setattr(module, "tempfile", types.SimpleNamespace(
        TemporaryDirectory=lambda: contextlib.nullcontext(str(path))))


def test_join_csv_example(monkeypatch, tmp_path):
    _fixed_tempdir(monkeypatch, join_csv, tmp_path / "port")
    _fixed_tempdir(monkeypatch, ref_join_csv, tmp_path / "ref")
    rec = join_csv.run(rows=5_000, **PORT)
    ref = ref_join_csv.run(rows=5_000, **REF)
    for name in ("a.csv", "b.csv"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())
    assert rec["out_rows"] == ref["out_rows"] > 0
    assert rec["rows_per_sec"] > 0 and rec["world"] == 4


def test_tpch_q1_example(monkeypatch):
    port, ref = _frames(monkeypatch)
    rec = tpch_q1.run(sf=0.003, **PORT)  # check=True inside
    want = ref_q1.run(sf=0.003, **REF)
    assert rec["groups"] == want["groups"] == 6
    got, exp = port[-1], ref[-1]
    _same_keys(got, exp, ["l_returnflag", "l_linestatus",
                          "count_l_discount"])
    _close(got, exp, [c for c in exp.columns if c.startswith(("sum_",
                                                               "mean_"))],
           rtol=1e-5)


def test_tpch_q3_example(monkeypatch):
    port, ref = _frames(monkeypatch)
    rec = tpch_q3.run(sf=0.004, **PORT)  # check=True inside: top-10
    want = ref_q3.run(sf=0.004, **REF)
    assert rec["top"] == want["top"] >= 1
    got = port[-1].head(tpch_q3.TOP_K)
    exp = ref[-1].head(ref_q3.TOP_K)
    _same_keys(got, exp, ["l_orderkey", "o_orderdate", "o_shippriority"])
    _close(got, exp, ["sum_revenue"], rtol=1e-4)


def test_tpch_q6_example():
    rec = tpch_q6.run(sf=0.02, **PORT)  # check=True inside
    want = ref_q6.run(sf=0.02, **REF)
    assert rec["revenue"] > 0
    np.testing.assert_allclose(rec["revenue"], want["revenue"], rtol=1e-4)


def test_tpch_q10_planner_example(monkeypatch):
    # the 4-way join through the planner: pandas-checked inside, at least
    # one elided shuffle, bit-identical to the eager lowering
    port, ref = _frames(monkeypatch)
    rec = tpch_q10.run(sf=0.004, compare_eager=True, **PORT)
    want = ref_q10.run(sf=0.004, compare_eager=True, **REF)
    assert rec["top"] == want["top"] == 20
    assert rec["shuffles_elided"] >= 1, rec
    assert rec["eager_bit_identical"] is True
    _same_keys(port[0], ref[0], ["c_custkey", "c_nationkey", "n_name"])
    _close(port[0], ref[0], ["sum_revenue"], rtol=1e-4)


def test_tpch_q5_planner_example(monkeypatch):
    port, ref = _frames(monkeypatch)
    rec = tpch_q5.run_plan(sf=0.004, **PORT)
    want = ref_q5.run_plan(sf=0.004, **REF)
    assert rec["nations"] == want["nations"] >= 1
    assert rec["shuffles_elided"] >= 1, rec
    _same_keys(port[0], ref[0], ["n_name"])
    _close(port[0], ref[0], ["sum_revenue"], rtol=1e-4)


def _by_nation(frame):
    return dict(zip(frame["n_name"], np.asarray(frame["sum_revenue"],
                                                np.float64)))


def test_tpch_q5_example(monkeypatch):
    port, ref = _frames(monkeypatch)
    rec = tpch_q5.run(sf=0.004, **PORT)
    want = ref_q5.run(sf=0.004, **REF)
    assert rec["nations"] == want["nations"] >= 1
    got, exp = _by_nation(port[-1]), _by_nation(ref[-1])
    assert sorted(got) == sorted(exp)
    for name in exp:
        np.testing.assert_allclose(got[name], exp[name], rtol=1e-4)


def test_tpch_q5_out_of_core_matches_golden(monkeypatch):
    """The full-preset Q5 path: the five-way join chained through the
    out-of-core engine, checked against the pandas golden inside, and
    nation for nation against the reference's engine."""
    import cylon_tpu.exec as ref_exec

    import cylon_tpu_torch.exec as port_exec

    port = _returns(monkeypatch, port_exec, "chunked_join_groupby_tables")
    ref = _returns(monkeypatch, ref_exec, "chunked_join_groupby_tables")
    rec = tpch_q5.run_ooc(sf=0.01, passes=3, check=True, device="cpu")
    want = ref_q5.run_ooc(sf=0.01, passes=3, check=True)
    assert rec["passes"] == want["passes"] == 3
    assert rec["nations"] == want["nations"] >= 1
    got, exp = _by_nation(port[0][0]), _by_nation(ref[0][0])
    assert sorted(got) == sorted(exp)
    for name in exp:
        np.testing.assert_allclose(got[name], exp[name], rtol=1e-4)


def _rows(cols):
    """The (k, a, b) rows as a sorted multiset."""
    k, a, b = (np.asarray(cols[c]) for c in "kab")
    order = np.lexsort((b, a.view(np.int32), k))
    return np.stack([k[order], a[order].view(np.int32), b[order]])


def test_shuffle_example(monkeypatch):
    port = _returns(monkeypatch, cylon_tpu_torch.Table, "shuffle")
    ref = _returns(monkeypatch, cylon_tpu.Table, "shuffle")
    rec = shuffle_bench.run(rows=20_000, reps=1, **PORT)
    want = ref_shuffle.run(rows=20_000, reps=1, **REF)
    assert rec["rows_per_sec"] > 0
    assert port[-1].row_count == ref[-1].row_count == rec["rows"] == 20_000
    got, exp = port[-1].to_numpy(), ref[-1].to_numpy()
    np.testing.assert_array_equal(_rows(got), _rows(exp))
    np.testing.assert_array_equal(
        _rows(got), _rows(shuffle_bench._gen_data(20_000, 0)))


def _flax_mlp():
    """The reference driver's Flax MLP (``examples/etl_to_flax.py``)."""
    import flax.linen as nn

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Dense(32)(x)
            x = nn.relu(x)
            x = nn.Dense(16)(x)
            x = nn.relu(x)
            return nn.Dense(1)(x)[:, 0]

    return MLP()


def _optax_losses(model, params, x, y, steps):
    import jax
    import optax

    opt = optax.adam(1e-3)
    state = opt.init(params)

    @jax.jit
    @jax.value_and_grad
    def loss_and_grads(p):
        return optax.sigmoid_binary_cross_entropy(model.apply(p, x),
                                                  y).mean()

    losses = []
    for _ in range(steps):
        loss, grads = loss_and_grads(params)
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return np.asarray(losses)


def _by_user(cols):
    order = np.argsort(np.asarray(cols["l_user"]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in cols.items()}


def test_etl_to_torch_example(monkeypatch):
    import jax

    model = _flax_mlp()
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, len(etl_to_torch.FEATURES)),
                                 np.float32))
    init = etl_to_torch.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params))
    port, ref = _frames(monkeypatch, "to_numpy")
    rec = etl_to_torch.run(events=10_000, users=500, steps=5, init=init,
                           **PORT)
    want = ref_etl.run(events=10_000, users=500, steps=5, **REF)
    assert np.isfinite(rec["final_loss"])
    assert rec["users"] == want["users"] == 500

    got, exp = _by_user(port[-1]), _by_user(ref[-1])
    np.testing.assert_array_equal(got["l_user"], exp["l_user"])
    np.testing.assert_array_equal(got["label"], exp["label"])
    _close(got, exp, etl_to_torch.FEATURES, rtol=1e-6)

    def matrix(cols):
        return np.stack([np.asarray(cols[c], np.float32)
                         for c in etl_to_torch.FEATURES], axis=1)

    losses = etl_to_torch.train(
        *etl_to_torch.trainer("cpu", init=init),
        torch.from_numpy(matrix(got)),
        torch.from_numpy(np.asarray(got["label"], np.float32)), 5)
    want_losses = _optax_losses(model, params, matrix(exp),
                                np.asarray(exp["label"], np.float32), 5)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-4)
    # the driver's own run started from the same weights
    assert abs(rec["final_loss"] - want_losses[-1]) <= 1e-3
    assert abs(rec["final_loss"] - want["final_loss"]) <= 2e-3


def test_etl_to_torch_seeds_its_weights_from_a_generator():
    a = etl_to_torch._seeded_state(3)
    b = etl_to_torch._seeded_state(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.weight"],
                           etl_to_torch._seeded_state(4)["layers.0.weight"])
    assert list(a) == list(etl_to_torch.MLP().state_dict())


def test_scaling_example():
    recs = scaling.run(rows_per_shard=4_000, mode="weak", max_world=4,
                       device="cpu")
    want = ref_scaling.run(rows_per_shard=4_000, mode="weak")
    assert len(recs) >= 2  # world 1 and at least one distributed point
    assert [r["world"] for r in recs] == [1, 2, 4]
    assert ([(r["world"], r["rows"]) for r in recs]
            == [(r["world"], r["rows"]) for r in want][:len(recs)])
    for r in recs:
        assert r["shuffle_rows_per_sec"] > 0
        assert r["join_rows_per_sec"] > 0 and r["groupby_rows_per_sec"] > 0
        assert r["cards"] == 1 and r["shared_card"] == (r["world"] > 1)


def test_dictionary_encoded_ingest(mesh4, ctx4):
    from cylon_tpu_torch import Table
    from cylon_tpu_torch import column as colmod

    d = pa.array(["a", "b", "a", None, "c"]).dictionary_encode()
    c = colmod.from_arrow(d, device="cpu")
    assert list(colmod.to_numpy(c, 5)) == ["a", "b", "a", None, "c"]
    v = [1.0, 2.0, 3.0, 4.0, 5.0]
    got = Table.from_arrow(pa.table({"k": d, "v": v}), ctx=mesh4).groupby(
        "k", {"v": ["sum"]}).to_pandas()
    want = cylon_tpu.Table.from_arrow(pa.table({"k": d, "v": v}),
                                      ctx=ctx4).groupby(
        "k", {"v": ["sum"]}).to_pandas()
    assert len(got) == len(want) == 4  # a, b, c, null group

    def groups(f):
        return sorted(zip(f["k"].astype(object).where(f["k"].notna(), None),
                          f["sum_v"]), key=lambda kv: (kv[0] is None,
                                                       kv[0] or ""))

    assert groups(got) == groups(want)
