"""Nothing the harness loads is JAX or the JAX package (top-level names
compared whole: ``cylon_tpu_torch`` begins with ``cylon_tpu`` and is the
program), the plain references load nothing of the program, and the
command prints no result where it cannot run."""
import ast
import json
import shutil
import subprocess
import sys

from benchmark import harness

from .conftest import TINY


def python(code: str, cwd=harness.ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=cwd, timeout=300)


def test_a_run_loads_no_jax():
    code = f"""
import json, sys, time
from benchmark import harness
for cell, over in {TINY!r}.items():
    out = harness.run_cell(cell, 7, 0.1, cell.startswith("tpch-q5"), "cpu",
                           time.perf_counter(), over)
    assert out["correct"], cell
print(json.dumps(sorted(sys.modules)))
"""
    proc = python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in loaded}
    assert "cylon_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_references_load_nothing_of_the_program():
    names = sorted(p.stem for p in (harness.BENCH / "reference").glob("*.py")
                   if p.stem != "__init__")
    code = ("import json, sys\n"
            + "".join(f"import benchmark.reference.{n}\n" for n in names)
            + "print(json.dumps(sorted(sys.modules)))")
    proc = python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(proc.stdout)}
    assert not tops & {"cylon_tpu_torch", *harness.FORBIDDEN}
    for path in (harness.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("cylon_tpu_torch",
                                               *harness.FORBIDDEN), path
                assert not m.startswith(("queries", "portio")), path


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "jg-sort-2p28",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tpch-q1-sf10",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
