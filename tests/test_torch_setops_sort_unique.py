"""The port's twin of ``tests/test_setops_sort_unique.py``: the same cases and pandas
oracles, run on ``cylon_tpu_torch`` on the CPU.

Set ops, sort, unique, shuffle, scalar aggregates — local + distributed.

Mirrors cpp/test/set_op_test.cpp, table_op_test.cpp, partition_test.cpp.
"""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import SortOptions, Table


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


# ---------------------------------------------------------------- set ops
def _set_frames(rng):
    a = pd.DataFrame({"k": rng.integers(0, 30, 80), "v": rng.integers(0, 3, 80)})
    b = pd.DataFrame({"k": rng.integers(15, 45, 60), "v": rng.integers(0, 3, 60)})
    return a, b


def _rowset(df):
    return set(map(tuple, df.to_numpy().tolist()))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_set_ops(request, rng, world):
    ctx = request.getfixturevalue("local_ctx" if world == 1 else f"ctx{world}")
    pa_, pb_ = _set_frames(rng)
    a = Table.from_pandas(pa_, ctx=ctx)
    b = Table.from_pandas(pb_, ctx=ctx)
    sa, sb = _rowset(pa_), _rowset(pb_)
    if world == 1:
        union, inter, sub = a.union(b), a.intersect(b), a.subtract(b)
    else:
        union = a.distributed_union(b)
        inter = a.distributed_intersect(b)
        sub = a.distributed_subtract(b)
    assert _rowset(union.to_pandas()) == sa | sb
    assert union.row_count == len(sa | sb)
    assert _rowset(inter.to_pandas()) == sa & sb
    assert _rowset(sub.to_pandas()) == sa - sb


# ---------------------------------------------------------------- sort
def test_local_sort_multi_col(local_ctx, rng):
    df = pd.DataFrame({"a": rng.integers(0, 5, 50), "b": rng.random(50)})
    t = Table.from_pandas(df, ctx=local_ctx).sort(["a", "b"])
    exp = df.sort_values(["a", "b"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(t.to_pandas(), exp)


def test_local_sort_descending(local_ctx, rng):
    df = pd.DataFrame({"a": rng.integers(0, 100, 40)})
    t = Table.from_pandas(df, ctx=local_ctx).sort("a", ascending=False)
    assert (np.diff(t.to_pandas()["a"].to_numpy()) <= 0).all()


def test_local_sort_strings(local_ctx):
    vals = ["pear", "apple", "fig", "apple", "banana"]
    t = Table.from_pydict({"s": vals}, ctx=local_ctx).sort("s")
    assert t.to_pydict()["s"] == sorted(vals)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_distributed_sort(request, rng, world):
    ctx = request.getfixturevalue(f"ctx{world}")
    df = pd.DataFrame({"a": rng.integers(0, 1000, 500), "b": rng.random(500)})
    t = Table.from_pandas(df, ctx=ctx).distributed_sort("a")
    got = t.to_pandas()  # gather concatenates shards in mesh order
    assert len(got) == len(df)
    assert (np.diff(got["a"].to_numpy()) >= 0).all()
    assert sorted(got["a"]) == sorted(df["a"])


@pytest.mark.parametrize("world", [2, 4, 8])
def test_distributed_sort_string_lead(request, rng, world):
    """Global sort on a STRING lead column — beyond the reference (its
    RangePartitionKernel is numeric only): the range partitioner bins on
    the 4-byte prefix; adversarial shared prefixes only hurt balance."""
    ctx = request.getfixturevalue(f"ctx{world}")
    n = 2000
    words = np.array([f"w{rng.integers(0, 500):04d}" for _ in range(n)],
                     object)
    # shared-prefix block stressing bin merging
    words[: n // 4] = np.array(
        [f"aaaa{rng.integers(0, 99):02d}" for _ in range(n // 4)], object)
    df = pd.DataFrame({"s": words, "v": rng.random(n)})
    t = Table.from_pandas(df, ctx=ctx).distributed_sort("s")
    got = t.to_pandas()["s"].tolist()
    assert got == sorted(words)


def test_distributed_sort_descending(request, rng, ctx4):
    df = pd.DataFrame({"a": rng.random(300)})
    t = Table.from_pandas(df, ctx=ctx4).distributed_sort(
        "a", options=SortOptions(ascending=False))
    got = t.to_pandas()["a"].to_numpy()
    assert (np.diff(got) <= 0).all()


# ---------------------------------------------------------------- unique
@pytest.mark.parametrize("world", [1, 2, 4])
def test_unique(request, rng, world):
    ctx = request.getfixturevalue("local_ctx" if world == 1 else f"ctx{world}")
    df = pd.DataFrame({"a": rng.integers(0, 20, 100)})
    t = Table.from_pandas(df, ctx=ctx)
    u = t.unique() if world == 1 else t.distributed_unique()
    assert sorted(u.to_pandas()["a"]) == sorted(df["a"].unique())


def test_unique_keep_first_order(local_ctx):
    t = Table.from_pydict({"a": [3, 1, 3, 2, 1]}, ctx=local_ctx)
    assert t.unique().to_pydict()["a"] == [3, 1, 2]
    assert t.unique(keep="last").to_pydict()["a"] == [3, 2, 1]


def test_unique_subset_columns(local_ctx):
    t = Table.from_pydict({"a": [1, 1, 2], "b": [9, 8, 7]}, ctx=local_ctx)
    u = t.unique(columns=["a"])
    assert u.to_pydict() == {"a": [1, 2], "b": [9, 7]}


# ---------------------------------------------------------------- shuffle
@pytest.mark.parametrize("world", [2, 4, 8])
def test_shuffle_preserves_rows_and_colocates(request, rng, world):
    ctx = request.getfixturevalue(f"ctx{world}")
    df = pd.DataFrame({"k": rng.integers(0, 37, 300), "v": rng.random(300)})
    t = Table.from_pandas(df, ctx=ctx)
    sh = t.shuffle("k")
    assert sh.row_count == len(df)
    got = sh.to_pandas()
    assert _rowset(got.round(9)) == _rowset(df.round(9))
    # keys must be colocated: each key appears in exactly one shard
    counts = sh.row_counts
    shard_of_key = {}
    for s in range(world):
        for val in sh.shards[s][0].data[:counts[s]].tolist():
            assert shard_of_key.setdefault(int(val), s) == s


# ------------------------------------------------------- scalar aggregates
@pytest.mark.parametrize("world", [1, 4])
def test_scalar_aggregates(request, rng, world):
    ctx = request.getfixturevalue("local_ctx" if world == 1 else f"ctx{world}")
    df = pd.DataFrame({"v": rng.random(200) * 100 - 50})
    t = Table.from_pandas(df, ctx=ctx)
    assert np.isclose(float(t.sum("v")), df["v"].sum())
    assert np.isclose(float(t.min("v")), df["v"].min())
    assert np.isclose(float(t.max("v")), df["v"].max())
    assert int(t.count("v")) == len(df)
