"""The reference's public surface on the port (ROADMAP C3): every name in
``cylon_tpu.__all__``, every public member of ``CylonContext`` and
``JoinConfig``, the ``JoinConfig`` factories with the reference's
signatures, and the port's twin of
``tests/test_join.py::test_join_config_parity``.

Named renames: ``TPUConfig`` is the port's ``MeshConfig``.
"""
import inspect
import threading

import numpy as np
import pandas as pd
import pytest

import cylon_tpu
import cylon_tpu_torch
from cylon_tpu.config import JoinConfig as RefJoinConfig
from cylon_tpu.context import CylonContext as RefContext
from cylon_tpu_torch import (CylonContext, JoinAlgorithm, JoinConfig,
                             JoinType, MeshConfig, Table)

#: reference name -> the port's name for it
RENAMED = {"TPUConfig": "MeshConfig"}


def _public(cls):
    return sorted(n for n in dir(cls) if not n.startswith("_"))


@pytest.mark.parametrize("name", sorted(cylon_tpu.__all__))
def test_top_level_names(name):
    port_name = RENAMED.get(name, name)
    assert port_name in cylon_tpu_torch.__all__, name
    assert hasattr(cylon_tpu_torch, port_name), name


def test_top_level_imports():
    from cylon_tpu_torch import (CommType, JoinAlgorithm, LocalConfig,  # noqa
                                 SortOptions)

    assert cylon_tpu_torch.__version__ == cylon_tpu.__version__


@pytest.mark.parametrize("member", _public(RefContext))
def test_context_members(member):
    assert hasattr(CylonContext, member), member


@pytest.mark.parametrize("member", _public(RefJoinConfig))
def test_join_config_members(member):
    assert hasattr(JoinConfig, member), member
    ref = getattr(RefJoinConfig, member)
    if callable(ref):
        assert list(inspect.signature(ref).parameters) == list(
            inspect.signature(getattr(JoinConfig, member)).parameters)


def test_join_algorithm_enum():
    assert {m.name: int(m) for m in JoinAlgorithm} == \
        {m.name: int(m) for m in cylon_tpu.JoinAlgorithm}


@pytest.mark.parametrize("factory,how", [
    ("InnerJoin", JoinType.INNER), ("LeftJoin", JoinType.LEFT),
    ("RightJoin", JoinType.RIGHT), ("FullOuterJoin", JoinType.FULL_OUTER)])
@pytest.mark.parametrize("algorithm", ["sort", "hash", JoinAlgorithm.SORT,
                                       JoinAlgorithm.HASH, "HASH"])
def test_factories_normalize_the_algorithm(factory, how, algorithm):
    cfg = getattr(JoinConfig, factory)("k", ["k"], algorithm)
    assert cfg.join_type == how
    assert cfg.left_on == ("k",) and cfg.right_on == ("k",)
    want = (JoinAlgorithm.HASH if algorithm in (JoinAlgorithm.HASH, "hash",
                                                "HASH") else JoinAlgorithm.SORT)
    assert cfg.algorithm is want
    assert JoinConfig(how, str(want.name).lower()).algorithm is want


def test_bad_algorithm_raises():
    with pytest.raises(ValueError, match="sort/hash"):
        JoinConfig.of("inner", "merge")


@pytest.fixture(scope="module")
def local_ctx():
    return CylonContext.Init("cpu")


def test_join_config_parity(local_ctx):
    """Reference-style JoinConfig objects (join_config.hpp factories);
    the twin of ``tests/test_join.py::test_join_config_parity``."""
    rng = np.random.default_rng(42)
    pl = pd.DataFrame({"k": rng.integers(0, 6, 30), "x": rng.random(30)})
    pr = pd.DataFrame({"k": rng.integers(0, 6, 30), "y": rng.random(30)})
    l = Table.from_pandas(pl, ctx=local_ctx)
    r = Table.from_pandas(pr, ctx=local_ctx)
    cfg = JoinConfig.InnerJoin(left_on="k", right_on="k", algorithm="hash")
    j = l.join(r, cfg)
    assert j.row_count == len(pl.merge(pr, on="k", how="inner"))


@pytest.mark.parametrize("world", [1, 4])
def test_enum_algorithm_runs_the_hash_join(world):
    """``JoinConfig.InnerJoin(0, 0, JoinAlgorithm.HASH)`` takes the hash
    join (its build rounds run) and gives ``algorithm="hash"``'s rows."""
    from cylon_tpu_torch.ops import hash_join

    ctx = (CylonContext.Init("cpu") if world == 1 else
           CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world)))
    rng = np.random.default_rng(5)
    l = Table.from_pydict({"k": rng.integers(0, 20, 90),
                           "x": rng.random(90)}, ctx=ctx)
    r = Table.from_pydict({"k": rng.integers(0, 20, 70),
                           "y": rng.random(70)}, ctx=ctx)
    hash_join.reset_rounds()
    got = l.distributed_join(r, JoinConfig.InnerJoin(0, 0,
                                                     JoinAlgorithm.HASH))
    assert hash_join.ROUNDS["build"] > 0
    want = l.distributed_join(r, on="k", algorithm="hash")
    assert got.row_counts.tolist() == want.row_counts.tolist()
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())


def test_context_surface():
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                  world_size=4))
    assert ctx.world_size == ctx.GetWorldSize() == 4
    assert ctx.GetNeighbours() == [1, 2, 3]
    assert ctx.GetNeighbours(include_self=True) == [0, 1, 2, 3]
    assert CylonContext.Init("cpu").GetNeighbours() == []
    assert ctx.GetConfig("missing") == "" and ctx.GetConfig("m", "d") == "d"
    ctx.AddConfig("compute_engine", "torch")
    assert ctx.GetConfig("compute_engine") == "torch"
    assert ctx.GetRank() == 0 and not ctx.multi_process()


def test_next_sequence_is_locked():
    """Every caller gets a distinct number, across threads."""
    ctx = CylonContext.Init("cpu")
    seen = []

    def take():
        for _ in range(200):
            seen.append(ctx.GetNextSequence())

    threads = [threading.Thread(target=take) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(seen) == list(range(1, 801))


def test_elastic_config_signature_and_context():
    """``ElasticConfig`` takes the reference's parameters, is a
    ``MeshConfig``, and a context without a coordinator refuses it."""
    from cylon_tpu.context import ElasticConfig as RefElastic
    from cylon_tpu_torch import CylonError, ElasticConfig
    from cylon_tpu_torch import config as pconfig

    assert list(inspect.signature(ElasticConfig).parameters) == \
        list(inspect.signature(RefElastic).parameters)
    cfg = ElasticConfig(3, devices=["cpu"])
    assert isinstance(cfg, MeshConfig) and cfg.rank == 3
    assert cfg.coordinator is None
    with pconfig.knob_env(CYLON_TPU_ELASTIC_COORD=None):
        with pytest.raises(CylonError, match="CYLON_TPU_ELASTIC_COORD"):
            CylonContext.InitDistributed(cfg)
    assert CylonContext.Init("cpu").elastic_agent() is None
