"""The port's twin of ``tests/test_shuffle_stress.py``: the same cases and pandas
oracles, run on ``cylon_tpu_torch`` on the CPU.

Adversarial shuffle distributions: total skew, empty shards, scale.

The reference's bucketed exchange streams only the rows that exist
(cpp/src/cylon/arrow/arrow_all_to_all.cpp:24-236); these tests pin the
same property onto the ragged shuffle — one hot key must not inflate
traffic or capacity beyond the data itself, and must stay correct.
"""
import numpy as np
import pandas as pd
import pytest


# -- the port's contexts, on the CPU (the conftest's are the JAX package's)
@pytest.fixture(scope="module")
def local_ctx():
    from cylon_tpu_torch import CylonContext

    return CylonContext.Init("cpu")


def _mesh(world):
    from cylon_tpu_torch import CylonContext, MeshConfig

    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world))


@pytest.fixture(scope="module")
def ctx2():
    return _mesh(2)


@pytest.fixture(scope="module")
def ctx4():
    return _mesh(4)


@pytest.fixture(scope="module")
def ctx8():
    return _mesh(8)


def _table(ctx, df):
    from cylon_tpu_torch.table import Table

    return Table.from_pandas(df, ctx=ctx)


@pytest.mark.parametrize("world_fixture", ["ctx4", "ctx8"])
def test_total_skew_one_hot_key(world_fixture, rng, request):
    """All rows share one key: every row lands on a single shard."""
    ctx = request.getfixturevalue(world_fixture)
    n = 4000
    df = pd.DataFrame({"k": np.full(n, 7, np.int64),
                       "v": rng.random(n)})
    t = _table(ctx, df)
    s = t.shuffle(["k"])
    assert s.row_count == n
    got = s.to_pandas().sort_values("v").reset_index(drop=True)
    exp = df.sort_values("v").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp)
    # the hot shard holds everything; the rest are empty
    per_shard = np.asarray(s.row_counts).ravel()
    assert per_shard.sum() == n and per_shard.max() == n


def test_skewed_join_groupby(ctx4, rng):
    """90% of rows share one key — join fan-out + groupby must agree with
    pandas (this is the distribution the bucketed plan over-padded on)."""
    n = 3000
    k = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 50, n)).astype(np.int64)
    left = pd.DataFrame({"k": k, "a": rng.random(n)})
    right = pd.DataFrame({"k": rng.integers(0, 50, 300).astype(np.int64),
                          "b": rng.random(300)})
    tl, tr = _table(ctx4, left), _table(ctx4, right)
    j = tl.distributed_join(tr, on="k", how="inner")
    exp_join = left.merge(right, on="k")
    assert j.row_count == len(exp_join)
    g = j.groupby("l_k", {"a": ["sum", "count"]})
    got = g.to_pandas().sort_values("l_k").reset_index(drop=True)
    exp = (exp_join.groupby("k").agg(sum_a=("a", "sum"), count_a=("a", "count"))
           .reset_index())
    np.testing.assert_allclose(got["sum_a"], exp["sum_a"], rtol=1e-9)
    assert np.array_equal(got["count_a"], exp["count_a"])


def test_fewer_rows_than_shards(ctx8):
    df = pd.DataFrame({"k": np.arange(3, dtype=np.int64), "v": [1.0, 2.0, 3.0]})
    t = _table(ctx8, df)
    s = t.shuffle(["k"])
    assert s.row_count == 3
    got = s.to_pandas().sort_values("k").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, df)


def test_empty_table_shuffle(ctx4):
    df = pd.DataFrame({"k": np.array([], np.int64), "v": np.array([], np.float64)})
    t = _table(ctx4, df)
    s = t.shuffle(["k"])
    assert s.row_count == 0


def test_shuffle_with_strings_and_nulls(ctx4, rng):
    n = 500
    words = np.array(["alpha", "beta", "gamma", None, "delta"], object)
    df = pd.DataFrame({"k": rng.integers(0, 20, n).astype(np.int64),
                       "s": words[rng.integers(0, 5, n)]})
    t = _table(ctx4, df)
    s = t.shuffle(["k"])
    assert s.row_count == n
    got = s.to_pandas()
    assert got["s"].isna().sum() == df["s"].isna().sum()
    assert sorted(got["s"].dropna()) == sorted(df["s"].dropna())


def test_all_to_all_matches_ragged_all_to_all_semantics(rng):
    """The port's exchange (``collectives.all_to_all``, which computes the
    reference's ``shuffle.ragged_plan`` offsets itself) against an
    independent numpy emulation of the documented collective
    (jax.lax.ragged_all_to_all: rank s's slice for rank t lands on t,
    front-packed in source order)."""
    import torch

    from cylon_tpu_torch.parallel import collectives

    dev = torch.device("cpu")
    for world in (2, 4, 8):
        for _ in range(5):
            cm = rng.integers(0, 50, (world, world)).astype(np.int32)
            out_cap = int(cm.sum(axis=0).max()) + 4
            # per-rank send buffers: rows sorted by destination, tagged
            # (src, dst, ordinal)
            send = [torch.from_numpy(np.concatenate(
                [np.array([(s, t, k) for k in range(cm[s, t])],
                          np.int64).reshape(-1, 3)
                 for t in range(world)])) for s in range(world)]
            out = [torch.full((out_cap, 3), -1, dtype=torch.int64,
                              device=dev) for _ in range(world)]
            collectives.all_to_all(send, cm, out)
            for t in range(world):
                total = int(cm[:, t].sum())
                got = out[t][:total].numpy()
                # front-packed: no unwritten gaps, all rows addressed to t,
                # source-major order with ordinals intact
                assert (got[:, 0] >= 0).all()
                assert (got[:, 1] == t).all()
                exp_srcs = np.repeat(np.arange(world), cm[:, t])
                assert np.array_equal(got[:, 0], exp_srcs)
                exp_ord = np.concatenate([np.arange(n) for n in cm[:, t]])
                assert np.array_equal(got[:, 2], exp_ord)
                assert (out[t][total:, 0] == -1).all()


def test_scalar_aggs_single_program(ctx4, rng):
    """distributed scalar aggs run as one psum/pmin/pmax program, including
    over shards with no rows."""
    n = 2000
    df = pd.DataFrame({"x": rng.integers(-1000, 1000, n).astype(np.int64)})
    t = _table(ctx4, df)
    assert int(t.sum("x")) == int(df["x"].sum())
    assert int(t.count("x")) == n
    assert int(t.min("x")) == int(df["x"].min())
    assert int(t.max("x")) == int(df["x"].max())
