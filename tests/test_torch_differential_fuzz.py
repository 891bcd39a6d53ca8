"""Randomized differential testing of the PyTorch port against pandas: the
pandas oracles of ``tests/test_differential_fuzz.py``, on the same seeded
random inputs (variable cardinality, negative keys, nulls, NaN floats,
empty sides, heavy skew), each distributed op checked against its pandas
mirror on a 4-shard CPU mesh; the ``*_compressed`` cases run it through
the packed, compressed exchange (``CYLON_TPU_SHUFFLE_PACK=1``,
``CYLON_TPU_SHUFFLE_COMPRESS=1``), as the JAX package's do.  Where the
JAX package's case runs a path the port does not have yet, its
counterpart runs the same oracle through the port's path for the same
result.  The planner's broadcast hash join and its skew salting run
through the port's planner (``Table.plan()``, ``CYLON_TPU_PLAN_ADAPTIVE``),
as the JAX package's cases do.  Still on a stand-in:

- the streaming tables' appends as ``Table.merge``: each micro-batch
  becomes a table and is merged on; the group-by (or join) after the last
  append matches pandas over the whole frame and the same op on the frame
  loaded at once, floats within rtol 1e-12.

The streaming tables themselves run as the JAX package's cases do
(``test_stream_*_incremental_differential``): the port's ``StreamTable``
with an empty and a one-row batch among the micro-batches, refreshed
after every append, each refresh equal to ``recompute_cold()`` and the
last to pandas.

Tolerances: float sums rtol 1e-9 in wide mode; the group-by cases also run
narrow (float32 accumulation) at rtol 1e-5.
"""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import CylonContext, MeshConfig, Table, config

from .torch_parity import modes

CAP = 512  # the reference suite's shared capacity
SEEDS = list(range(12))


def _mesh(world):
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world))


@pytest.fixture(scope="module")
def pctx4():
    return _mesh(4)


@pytest.fixture()
def compressed(monkeypatch):
    """The packed, compressed exchange for one test."""
    monkeypatch.setenv("CYLON_TPU_SHUFFLE_PACK", "1")
    monkeypatch.setenv("CYLON_TPU_SHUFFLE_COMPRESS", "1")


def _rand_frame(rng, allow_empty=True):
    n = int(rng.integers(0 if allow_empty else 1, 120))
    card = int(rng.integers(1, 40))
    lo = int(rng.integers(-50, 1))
    k = rng.integers(lo, lo + card, n).astype(np.int64)
    if n and rng.random() < 0.3:  # heavy skew: most rows one key
        k[rng.random(n) < 0.7] = lo
    v = rng.random(n)
    if n and rng.random() < 0.5:  # null floats through a pandas NaN column
        v[rng.random(n) < 0.2] = np.nan
    return pd.DataFrame({"k": k, "v": v})


def _mk(df, ctx):
    return Table.from_pandas(df, ctx=ctx, capacity=CAP)


def _multiset(df, ndigits=6):
    out = []
    for row in df.itertuples(index=False):
        norm = []
        for x in row:
            if x is None or (isinstance(x, float) and np.isnan(x)):
                norm.append(None)
            elif isinstance(x, (float, np.floating)):
                norm.append(round(float(x), ndigits))
            else:
                norm.append(int(x) if isinstance(x, np.integer) else x)
        out.append(tuple(norm))
    return sorted(out, key=lambda t: tuple((e is None, e) for e in t))


def _assert_same(table, golden: pd.DataFrame):
    got = table.to_pandas()
    assert list(got.columns) == list(golden.columns), \
        (list(got.columns), list(golden.columns))
    assert _multiset(got) == _multiset(golden)


def _sorted_values(col):
    return np.sort(np.nan_to_num(np.asarray(col, dtype=float), nan=-7e9))


def _check_join(got, g):
    assert len(got) == len(g)
    np.testing.assert_allclose(_sorted_values(got["l_v"]),
                               _sorted_values(g["v_l"]), rtol=1e-12)
    np.testing.assert_allclose(_sorted_values(got["r_v"]),
                               _sorted_values(g["v_r"]), rtol=1e-12)


def _join_case(ctx, seed, algorithm="sort"):
    rng = np.random.default_rng(1000 + seed)
    how = ["inner", "left", "right", "outer"][seed % 4]
    ldf, rdf = _rand_frame(rng), _rand_frame(rng)
    t = _mk(ldf, ctx).distributed_join(_mk(rdf, ctx), on="k", how=how,
                                       algorithm=algorithm)
    g = ldf.merge(rdf, on="k", how=how, suffixes=("_l", "_r"))
    got = t.to_pandas()
    # both columns collide, so cylon emits l_k, l_v, r_k, r_v while pandas
    # keeps one merged key; compare row count + per-side value multisets
    assert list(got.columns) == ["l_k", "l_v", "r_k", "r_v"], got.columns
    _check_join(got, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_join_differential(pctx4, seed):
    _join_case(pctx4, seed)


def _groupby_case(ctx, seed, mode):
    rng = np.random.default_rng(2000 + seed)
    df = _rand_frame(rng, allow_empty=False)
    with modes(mode):
        t = _mk(df, ctx).groupby("k", {"v": ["sum", "count", "min", "max"]})
    g = (df.groupby("k")
         .agg(sum_v=("v", "sum"), count_v=("v", "count"),
              min_v=("v", "min"), max_v=("v", "max")).reset_index())
    got = t.to_pandas().sort_values("k").reset_index(drop=True)
    g = g.sort_values("k").reset_index(drop=True)
    rtol = 1e-5 if mode == "narrow" else 1e-9
    np.testing.assert_array_equal(got["k"], g["k"])
    np.testing.assert_array_equal(got["count_v"], g["count_v"])
    # all-null groups: pandas sum is 0.0 (skipna, min_count=0) while cylon
    # reports null -> NaN; normalize to pandas' convention for comparison
    np.testing.assert_allclose(np.nan_to_num(got["sum_v"].to_numpy()),
                               g["sum_v"], rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(got["min_v"], g["min_v"], rtol=rtol,
                               atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(got["max_v"], g["max_v"], rtol=rtol,
                               atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("seed", SEEDS)
def test_groupby_differential(pctx4, seed, mode):
    _groupby_case(pctx4, seed, mode)


@pytest.mark.parametrize("seed", SEEDS)
def test_sort_unique_differential(pctx4, seed):
    rng = np.random.default_rng(3000 + seed)
    df = _rand_frame(rng)
    t = _mk(df, pctx4)
    srt = t.distributed_sort("k")
    got = srt.to_pandas()
    ks = got["k"].to_numpy()
    assert np.all(np.diff(ks) >= 0) and len(ks) == len(df)
    # row integrity: (k, v) pairs survive the sort as a multiset
    assert _multiset(got) == _multiset(df)
    uq = t.distributed_unique(["k"])
    assert uq.row_count == (df["k"].nunique() if len(df) else 0)


@pytest.mark.parametrize("seed", SEEDS[:8])
def test_setops_differential(pctx4, seed):
    rng = np.random.default_rng(4000 + seed)
    a = _rand_frame(rng).drop_duplicates().reset_index(drop=True)
    b = _rand_frame(rng).drop_duplicates().reset_index(drop=True)
    # NaN-free float payloads, rounded, so bit-exact equality is meaningful
    a["v"] = np.nan_to_num(a["v"].to_numpy(), nan=0.25).round(3)
    b["v"] = np.nan_to_num(b["v"].to_numpy(), nan=0.25).round(3)
    a = a.drop_duplicates().reset_index(drop=True)
    b = b.drop_duplicates().reset_index(drop=True)
    ta, tb = _mk(a, pctx4), _mk(b, pctx4)
    am = set(map(tuple, a.itertuples(index=False)))
    bm = set(map(tuple, b.itertuples(index=False)))
    un = ta.distributed_union(tb)
    assert un.row_count == len(am | bm)
    _assert_same(un, pd.DataFrame(sorted(am | bm), columns=["k", "v"]))
    assert ta.distributed_subtract(tb).row_count == len(am - bm)
    assert ta.distributed_intersect(tb).row_count == len(am & bm)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_select_filter_differential(pctx4, seed):
    rng = np.random.default_rng(5000 + seed)
    df = _rand_frame(rng, allow_empty=False)
    thr = float(rng.random())
    t = _mk(df, pctx4).select(lambda env, thr=thr: env["v"] > thr)
    vals = df["v"].to_numpy()
    assert t.row_count == int(((~np.isnan(vals)) & (vals > thr)).sum())


def _string_case(ctx, seed, mode="wide"):
    rng = np.random.default_rng(6000 + seed)
    n = int(rng.integers(1, 120))
    m = int(rng.integers(1, 120))
    card = int(rng.integers(1, 25))
    pool = np.array([f"key_{i:03d}" for i in range(card)], object)
    ldf = pd.DataFrame({"s": pool[rng.integers(0, card, n)],
                        "v": rng.random(n)})
    rdf = pd.DataFrame({"s": pool[rng.integers(0, card, m)],
                        "w": rng.random(m)})
    t = _mk(ldf, ctx).distributed_join(_mk(rdf, ctx), on="s", how="inner")
    assert t.row_count == len(ldf.merge(rdf, on="s", how="inner"))
    with modes(mode):
        gb = _mk(ldf, ctx).groupby("s", {"v": ["sum", "count"]})
    gg = (ldf.groupby("s").agg(sum_v=("v", "sum"), count_v=("v", "count"))
          .reset_index())
    got = gb.to_pandas().sort_values("s").reset_index(drop=True)
    gg = gg.sort_values("s").reset_index(drop=True)
    assert list(got["s"]) == list(gg["s"])
    np.testing.assert_allclose(got["sum_v"], gg["sum_v"],
                               rtol=1e-5 if mode == "narrow" else 1e-9)
    np.testing.assert_array_equal(got["count_v"], gg["count_v"])


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_string_key_join_groupby_differential(pctx4, seed):
    _string_case(pctx4, seed)


@pytest.mark.parametrize("seed", SEEDS[:8])
def test_hash_algorithm_join_differential(pctx4, seed):
    """The hash join must agree with pandas (and thus with the sort join)
    under the same random nulls and skew."""
    rng = np.random.default_rng(7000 + seed)
    how = ["inner", "left", "right", "outer"][seed % 4]
    ldf, rdf = _rand_frame(rng), _rand_frame(rng)
    t = _mk(ldf, pctx4).distributed_join(_mk(rdf, pctx4), on="k", how=how,
                                         algorithm="hash")
    _check_join(t.to_pandas(),
                ldf.merge(rdf, on="k", how=how, suffixes=("_l", "_r")))


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_join_differential_compressed(pctx4, seed, compressed):
    """The compressed exchange under the join grid's random nulls, skew
    and negative keys agrees with pandas."""
    _join_case(pctx4, seed)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_groupby_differential_compressed(pctx4, seed, compressed):
    """The compressed partial shuffle of the group-by."""
    _groupby_case(pctx4, seed, "wide")


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_string_key_compressed_differential(pctx4, seed, compressed):
    """Dictionary-coded string keys through the join and group-by."""
    _string_case(pctx4, seed, "narrow")


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_tiny_dimension_broadcast_differential(pctx4, seed):
    """The planner's adaptive broadcast-hash join over a tiny dimension
    side (the dimension gathered onto every shard, the fact side probing
    in place) against the pandas merge (random fact cardinality, dangling
    negative keys, NaN payloads)."""
    rng = np.random.default_rng(8000 + seed)
    n = int(rng.integers(64, 400))
    card = int(rng.integers(2, 24))
    fact = pd.DataFrame({"k": rng.integers(-4, card, n).astype(np.int64),
                         "v": rng.random(n)})
    if rng.random() < 0.5:
        fact.loc[rng.random(n) < 0.2, "v"] = np.nan
    dim = pd.DataFrame({"k": np.arange(card, dtype=np.int64),
                        "w": rng.random(card)})
    q = (_mk(fact, pctx4).plan()
         .join(Table.from_pandas(dim, ctx=pctx4, capacity=64), on="k",
               how="inner"))
    with config.knob_env(CYLON_TPU_PLAN_ADAPTIVE="1"):
        assert "BROADCAST(k)" in q.explain()
        got = q.execute().to_pandas()
    g = fact.merge(dim, on="k", how="inner")
    assert len(got) == len(g)
    np.testing.assert_allclose(_sorted_values(got["l_k"]),
                               _sorted_values(g["k"]), rtol=0)
    np.testing.assert_allclose(_sorted_values(got["v"]),
                               _sorted_values(g["v"]), rtol=1e-12)
    np.testing.assert_allclose(np.sort(got["w"].to_numpy()),
                               np.sort(g["w"].to_numpy()), rtol=1e-12)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_zipfian_salted_nunique_differential(pctx4, seed, tmp_path):
    """The planner's skew-salted NUNIQUE against the pandas oracle: a
    profiled run seeds the statistics catalog (the salt rule fires only on
    observed skew), then the salted plan must agree exactly with pandas
    and with its own unsalted run."""
    rng = np.random.default_rng(9000 + seed)
    n = int(rng.integers(200, 500))
    df = pd.DataFrame(
        {"k": (np.minimum(rng.zipf(1.3, n), 40) - 1).astype(np.int64),
         "u": rng.integers(0, 60, n).astype(np.int64)})
    q = _mk(df, pctx4).plan().groupby(["k"], {"u": ["nunique"]})
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path)):
        with config.knob_env(CYLON_TPU_PLAN_ADAPTIVE="0",
                             CYLON_TPU_PROFILE="1"):
            plain = q.execute()
        with config.knob_env(CYLON_TPU_PLAN_ADAPTIVE="1",
                             CYLON_TPU_PLAN_SKEW_SALT="1.01"):
            assert "salted x4" in q.explain()
            salted = q.execute()
    g = (df.groupby("k").agg(nunique_u=("u", "nunique")).reset_index())
    got = salted.to_pandas().sort_values("k").reset_index(drop=True)
    g = g.sort_values("k").reset_index(drop=True)
    np.testing.assert_array_equal(got["k"], g["k"])
    np.testing.assert_array_equal(got["nunique_u"], g["nunique_u"])
    pd.testing.assert_frame_equal(
        got, plain.to_pandas().sort_values("k").reset_index(drop=True))


def _split_batches(df, rng):
    """Cut a frame into micro-batches at random split points, always with
    the two degenerate shapes: an EMPTY batch and a SINGLE-ROW batch."""
    n = len(df)
    cuts = sorted(set(rng.integers(0, n + 1, int(rng.integers(1, 5)))))
    edges = [0] + cuts + [n]
    batches = [df.iloc[a:b] for a, b in zip(edges, edges[1:])]
    batches.insert(int(rng.integers(0, len(batches) + 1)), df.iloc[0:0])
    batches.insert(int(rng.integers(0, len(batches) + 1)), df.iloc[n - 1:n])
    return batches, pd.concat(batches, ignore_index=True)


def _appended(batches, ctx):
    """The micro-batches appended one by one with ``Table.merge``."""
    t = None
    for b in batches:
        bt = _mk(b.reset_index(drop=True), ctx)
        t = bt if t is None else t.merge(bt)
    return t


def _same_result(a: Table, b: Table):
    """Equal frames up to row order (both sorted by every column): exact
    but for floats, rtol 1e-12 (appending moves rows between shards, so
    partial sums add in another order)."""
    fa, fb = a.to_pandas(), b.to_pandas()
    cols = list(fa.columns)
    fa = fa.sort_values(cols, kind="stable").reset_index(drop=True)
    fb = fb.sort_values(cols, kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(fa, fb, check_exact=False, rtol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_groupby_differential(pctx4, seed):
    """The group-by after appending every micro-batch against the pandas
    oracle over the frozen concatenation, and against the group-by of that
    concatenation loaded at once."""
    rng = np.random.default_rng(7000 + seed)
    df = _rand_frame(rng, allow_empty=False)
    batches, frozen = _split_batches(df, rng)
    aggs = {"v": ["sum", "count", "min", "max"]}
    got_t = _appended(batches, pctx4).groupby("k", aggs)
    _same_result(got_t, _mk(frozen, pctx4).groupby("k", aggs))
    g = (frozen.groupby("k")
         .agg(sum_v=("v", "sum"), count_v=("v", "count"),
              min_v=("v", "min"), max_v=("v", "max")).reset_index()
         .sort_values("k").reset_index(drop=True))
    got = got_t.to_pandas().sort_values("k").reset_index(drop=True)
    np.testing.assert_array_equal(got["k"], g["k"])
    np.testing.assert_array_equal(got["count_v"], g["count_v"])
    np.testing.assert_allclose(np.nan_to_num(got["sum_v"].to_numpy()),
                               g["sum_v"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["min_v"], g["min_v"], rtol=1e-9,
                               atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(got["max_v"], g["max_v"], rtol=1e-9,
                               atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_join_differential(pctx4, seed):
    """The fact side appended in micro-batches, joined to a static
    dimension table, against pandas merging the frozen concatenation, and
    equal to the join of that concatenation loaded at once."""
    rng = np.random.default_rng(8000 + seed)
    how = ["inner", "left"][seed % 2]
    fact = _rand_frame(rng, allow_empty=False)
    dim = _rand_frame(rng).rename(columns={"v": "w"}).drop_duplicates("k")
    batches, frozen = _split_batches(fact, rng)
    dim_t = _mk(dim.reset_index(drop=True), pctx4)
    got_t = _appended(batches, pctx4).distributed_join(dim_t, on="k",
                                                       how=how)
    _same_result(got_t, _mk(frozen, pctx4).distributed_join(
        dim_t, on="k", how=how))
    got = got_t.to_pandas()
    g = frozen.merge(dim, on="k", how=how)
    assert len(got) == len(g)
    for got_col, ref_col in (("v", "v"), ("w", "w")):
        np.testing.assert_allclose(_sorted_values(got[got_col]),
                                   _sorted_values(g[ref_col]), rtol=1e-12)


# -- the port's streaming tables, as the JAX package's stream cases ----------

def _as_floats(col):
    """Exported float columns hold None in an object array for nulls."""
    return np.array([np.nan if x is None else float(x)
                     for x in np.asarray(col).ravel()])


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_groupby_incremental_differential(seed, tmp_path):
    """Incremental refresh after EVERY micro-batch (an empty and a
    one-row batch among them) against the pandas oracle over the frozen
    concatenation, and at each watermark equal to the cold recompute."""
    from cylon_tpu_torch.stream import GroupByQuery, StreamTable

    rng = np.random.default_rng(7000 + seed)
    df = _rand_frame(rng, allow_empty=False)
    batches, frozen = _split_batches(df, rng)
    cpu = CylonContext.Init("cpu")
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        s = StreamTable(f"fuzz-gb-{seed}")
        q = None
        for b in batches:
            s.append({c: b[c].to_numpy() for c in b.columns})
            if q is None:
                q = GroupByQuery(s, ["k"],
                                 {"v": ["sum", "count", "min", "max"]},
                                 ctx=cpu)
            frame, stats = q.refresh()
            assert stats["watermark"] == s.watermark
            cold = q.recompute_cold()
            for name in cold:
                a, c = np.asarray(frame[name]), np.asarray(cold[name])
                assert a.dtype == c.dtype and a.tolist() == c.tolist(), name
    g = (frozen.groupby("k")
         .agg(sum_v=("v", "sum"), count_v=("v", "count"),
              min_v=("v", "min"), max_v=("v", "max")).reset_index()
         .sort_values("k").reset_index(drop=True))
    got = (pd.DataFrame({k: frame[k] for k in frame})
           .sort_values("k").reset_index(drop=True))
    np.testing.assert_array_equal(got["k"], g["k"])
    np.testing.assert_array_equal(got["count_v"], g["count_v"])
    # an all-null group: pandas sums to 0.0, the stream gives a null
    np.testing.assert_allclose(np.nan_to_num(_as_floats(got["sum_v"])),
                               g["sum_v"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_as_floats(got["min_v"]), g["min_v"],
                               rtol=1e-9, atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(_as_floats(got["max_v"]), g["max_v"],
                               rtol=1e-9, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_join_incremental_differential(seed, tmp_path):
    """The fact stream joined to a static dimension table: every batch
    probes once, the refresh equals the cold recompute and pandas merging
    the frozen concatenation."""
    from cylon_tpu_torch.stream import JoinQuery, StreamTable

    rng = np.random.default_rng(8000 + seed)
    how = ["inner", "left"][seed % 2]
    fact = _rand_frame(rng, allow_empty=False)
    dim = _rand_frame(rng).rename(columns={"v": "w"}).drop_duplicates("k")
    batches, frozen = _split_batches(fact, rng)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        s = StreamTable(f"fuzz-join-{seed}")
        for b in batches:
            s.append({c: b[c].to_numpy() for c in b.columns})
        j = JoinQuery(s, {c: dim[c].to_numpy() for c in dim.columns},
                      on="k", how=how, ctx=CylonContext.Init("cpu"))
        frame, stats = j.refresh()
        assert stats["parts_run"] == len(batches)
        cold = j.recompute_cold()
        for name in cold:
            a, c = np.asarray(frame[name]), np.asarray(cold[name])
            assert a.dtype == c.dtype and a.tolist() == c.tolist(), name
    g = frozen.merge(dim, on="k", how=how)
    first_val = next(c for c in frame if c not in ("l_k", "r_k", "k"))
    assert len(np.asarray(frame[first_val])) == len(g)
    for got_col, ref_col in (("l_v", "v"), ("r_w", "w")):
        if got_col not in frame:
            got_col = ref_col  # no name collision: unprefixed
        np.testing.assert_allclose(
            np.sort(np.nan_to_num(_as_floats(frame[got_col]), nan=-7e9)),
            np.sort(np.nan_to_num(g[ref_col].to_numpy(dtype=float),
                                  nan=-7e9)),
            rtol=1e-12)
