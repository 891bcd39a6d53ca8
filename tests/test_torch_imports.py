"""The PyTorch port stands alone: it imports torch, never jax and nothing
of the JAX package, and its entry points never fall back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cylon_tpu_torch
from cylon_tpu_torch import column, exec as exec_mod, interop, pipeline
from cylon_tpu_torch.ops import scan
from cylon_tpu_torch.status import CylonError

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "cylon_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cylon_tpu")


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cylon_tpu_torch\n"
        "for m in pkgutil.walk_packages(cylon_tpu_torch.__path__,\n"
        "                               'cylon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert 'torch' in sys.modules\n"
        "assert not bad, bad\n"
        "print('imported', sum(1 for m in sys.modules\n"
        "      if m.startswith('cylon_tpu_torch')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    # every module of the package, the out-of-core engine's, the
    # journal's (durable_lease, durable_sync, net/, router/) and the
    # serving layer's (serve/, stream/, obs/openmetrics) included
    assert int(out.stdout.split()[-1]) >= 79


def test_fleet_modules_load_no_jax():
    """``cylon_tpu_torch.elastic`` and ``cylon_tpu_torch.router`` (the
    gang, the router, its replicas) load neither jax nor the JAX
    package, whose ``elastic.py`` and ``router/`` they copy."""
    code = (
        "import sys\n"
        "import cylon_tpu_torch.elastic\n"
        "import cylon_tpu_torch.router\n"
        "from cylon_tpu_torch.router import QueryRouter, ReplicaServer\n"
        "from cylon_tpu_torch import ElasticConfig, net\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_analysis_loads_no_jax():
    """``cylon_tpu_torch.analysis`` (cylint on the port: the AST and lock
    rules, the budgets, the CLI) loads neither jax nor the JAX package,
    whose ``analysis/`` it copies, even while it runs."""
    code = (
        "import sys\n"
        "import cylon_tpu_torch.analysis\n"
        "from cylon_tpu_torch.analysis import astlint, budgets, locks\n"
        "from cylon_tpu_torch.analysis.__main__ import main\n"
        "assert main(['--list-rules']) == 0\n"
        "assert astlint.scan_paths(['cylon_tpu_torch/analysis']) == []\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_import_loads_neither_pandas_nor_pyarrow():
    """``import cylon_tpu_torch`` (its I/O layer, native library bindings
    and frames included) loads neither pandas nor pyarrow: each is imported
    only inside the functions that need it."""
    code = (
        "import sys\n"
        "import cylon_tpu_torch\n"
        "from cylon_tpu_torch import frame, index, io, native, series\n"
        "from cylon_tpu_torch.io import arrow_io, csv_config\n"
        "from cylon_tpu_torch.native import build\n"
        "from cylon_tpu_torch import serve, stream\n"
        "from cylon_tpu_torch.obs import export, openmetrics\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('pandas', 'pyarrow', 'jax',\n"
        "                                    'cylon_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("module", ["io", "io/arrow_io", "io/csv_config",
                                    "native", "native/build", "frame",
                                    "series", "index", "durable_lease",
                                    "durable_sync", "net", "net/control",
                                    "router", "router/wire", "serve",
                                    "serve/service", "serve/cache",
                                    "stream", "stream/state",
                                    "stream/table", "stream/incremental",
                                    "obs/openmetrics", "obs/export",
                                    "obs/fleet", "obs/tracectx",
                                    "elastic", "router/service",
                                    "router/replica"])
def test_front_door_modules_import_no_jax(module):
    """The I/O layer, the native bindings, the frames, the journal's
    stdlib modules (its lease, transport and wire codec) and the serving
    layer (the query service, streams, the OpenMetrics exposition) are
    copies of the JAX package's modules, never imports of them."""
    path = PKG / f"{module}.py"
    if not path.exists():
        path = PKG / module / "__init__.py"
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    """No card and no device= -> a classified error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(4, dtype=np.int32)
    with pytest.raises(CylonError, match="no CUDA device"):
        cylon_tpu_torch.default_device()
    with pytest.raises(CylonError, match="no CUDA device"):
        column.from_numpy(x)
    with pytest.raises(CylonError, match="no CUDA device"):
        interop.column_from_arrays(x, np.ones(4, bool), None,
                                   cylon_tpu_torch.dtypes.int32)
    with pytest.raises(CylonError, match="no CUDA device"):
        pipeline.tables(x, x.astype(np.float32), x, x.astype(np.float32))
    with pytest.raises(CylonError, match="no CUDA device"):
        exec_mod.chunked_join({"k": x}, {"k": x}, on="k", passes=2)
    with pytest.raises(CylonError, match="no CUDA device"):
        pipeline.out_of_core_join_groupby(
            (x, x.astype(np.float32), x, x.astype(np.float32)), 2)
    from cylon_tpu_torch.serve import QueryService
    from cylon_tpu_torch.stream import GroupByQuery, StreamTable

    with pytest.raises(CylonError, match="no CUDA device"):
        QueryService()
    s = StreamTable("no-card")
    s.append({"k": x})
    with pytest.raises(CylonError, match="no CUDA device"):
        GroupByQuery(s, "k", {"k": "count"})
    # an explicit CPU request runs
    col = column.from_numpy(x, device="cpu")
    assert col.data.device.type == "cpu"


def test_scan_wrappers_take_plain_version_only_on_cpu():
    x = torch.arange(10, dtype=torch.int32)
    scan.reset_launches()
    torch.testing.assert_close(scan.scan_1d(x, "sum"),
                               torch.cumsum(x, 0, dtype=torch.int32))
    assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        scan.scan_1d(x.to("meta"), "sum")
    with pytest.raises(ValueError, match="1-D int32"):
        scan.scan_1d(x.to(torch.int64), "sum")
    with pytest.raises(ValueError, match="scan op"):
        scan.scan_1d(x, "prod")
    with pytest.raises(ValueError, match="reset must be"):
        scan.segmented_scan(x, torch.zeros(3, dtype=torch.bool), "sum")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Run from a directory holding only chip_smoke.py: no card here, so it
    must exit non-zero and print no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
