"""The port's twin of ``tests/test_api_parity.py``: the same cases and pandas
oracles, run on ``cylon_tpu_torch`` on the CPU.

pycylon API-parity surface: show/from_list/clear/to_string/index/
isna/notna/retain_memory (reference: python/pycylon/data/table.pyx)."""
import numpy as np
import pytest

from cylon_tpu_torch import Table
from cylon_tpu_torch.index import ColumnIndex, RangeIndex


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


def test_from_list_and_to_string(local_ctx):
    t = Table.from_list(["a", "b"], [[1, 2, 3], [4.0, 5.0, 6.0]],
                        ctx=local_ctx)
    assert t.row_count == 3 and t.column_names == ["a", "b"]
    s = t.to_string(2)
    assert s.splitlines()[0] == "a,b"
    assert len(s.splitlines()) == 3


def test_show_and_print(local_ctx, capsys):
    t = Table.from_list(["x", "y"], [[10, 20, 30], [1, 2, 3]], ctx=local_ctx)
    t.show()
    out1 = capsys.readouterr().out
    assert "30" in out1
    t.show(row1=1)  # open-ended row range prints to the end
    out2 = capsys.readouterr().out
    assert "20" in out2 and "30" in out2 and "10" not in out2
    t.show(col1=1)  # open-ended column range keeps trailing columns
    out3 = capsys.readouterr().out
    assert "y" in out3 and "x" not in out3


def test_clear_and_retain(local_ctx):
    t = Table.from_list(["x"], [[1, 2]], ctx=local_ctx)
    t.retain_memory(False)
    assert t.is_retain()
    t.clear()
    assert t.row_count == 0


def test_index_surface(local_ctx):
    t = Table.from_list(["k", "v"], [[1, 2, 3], [9, 8, 7]], ctx=local_ctx)
    assert isinstance(t.index, RangeIndex)
    assert t.index.stop == 3
    t.set_index("k")
    assert isinstance(t.index, ColumnIndex)
    t.reset_index()
    assert isinstance(t.index, RangeIndex)


def test_isna_notna_alias(local_ctx):
    t = Table.from_list(["v"], [[1.0, np.nan, 3.0]], ctx=local_ctx)
    na = t.isna().to_pandas()["v"]
    assert list(na) == [False, True, False]
    assert list(t.notna().to_pandas()["v"]) == [True, False, True]


def test_shape_and_context(local_ctx):
    """reference: data/table.pyx:981 (shape), :207 (context)."""
    t = Table.from_list(["k", "v"], [[1, 2, 3], [9, 8, 7]], ctx=local_ctx)
    assert t.shape == (3, 2)
    assert t.context is local_ctx
