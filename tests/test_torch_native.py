"""The port's own copy of the host C++ library (``cylon_tpu_torch/native``):
every case of ``tests/test_native.py`` against it, and its row hash,
partition targets and CSV reader held against the JAX package's library on
the same inputs, exactly.  The library must be built from the port's
sources into ``build/cylon_tpu_torch/native/``, never the JAX package's
``libcylon_tpu.so``."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from cylon_tpu import native as rnative
from cylon_tpu_torch import CylonContext, Table, native
from cylon_tpu_torch.config import knob_env
from cylon_tpu_torch.native import build as native_build

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
INCLUDE = REPO / "cylon_tpu_torch" / "native" / "include"


@pytest.fixture(autouse=True)
def _native():
    if not native.available():
        pytest.skip(f"native layer unavailable: {native.load_error()}")


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.Init("cpu")


# -- where the library comes from -----------------------------------------

def test_library_is_built_from_the_port_sources():
    lib = native_build.build()
    assert lib.parent == REPO / "build" / "cylon_tpu_torch" / "native"
    assert lib.name.startswith("libcylon_tpu_") and lib.suffix == ".so"
    assert native_build.SRC_DIR == REPO / "cylon_tpu_torch" / "native" / "src"
    assert native._lib._name == str(lib)
    assert str(lib) in Path(f"/proc/{os.getpid()}/maps").read_text()


def test_library_loads_without_the_reference_in_a_fresh_process():
    """In a process that never imports the JAX package, the port loads
    only its own build of the library."""
    code = ("import os, sys\n"
            "from cylon_tpu_torch import native\n"
            "assert native.available(), native.load_error()\n"
            "maps = open(f'/proc/{os.getpid()}/maps').read()\n"
            "libs = {l.split()[-1] for l in maps.splitlines()\n"
            "        if 'libcylon_tpu' in l}\n"
            "assert not any('cylon_tpu/native/' in p for p in libs), libs\n"
            "assert all('/build/cylon_tpu_torch/native/' in p\n"
            "           for p in libs) and libs, libs\n"
            "assert not any(m.split('.')[0] in ('jax', 'cylon_tpu')\n"
            "               for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_failed_build_is_loud(tmp_path, monkeypatch, capfd):
    """A broken toolchain makes the library unavailable (the I/O layer
    falls back to pyarrow) and prints the compiler's error."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    assert not native.available()
    assert "native build failed" in native.load_error()
    assert "native build failed" in capfd.readouterr().err


# -- murmur3 / hashing ------------------------------------------------------

def test_murmur3_known_vectors():
    # public MurmurHash3_x86_32 test vectors
    assert native.murmur3_32(b"", 0) == 0
    assert native.murmur3_32(b"hello", 0) == 0x248BFA47
    assert native.murmur3_32(b"hello, world", 0) == 0x149BBB7F
    assert native.murmur3_32(b"", 1) == 0x514E28B7


def test_row_hash_matches_single_column_murmur():
    k = np.array([0, 1, 2, 1 << 40], dtype=np.int64)
    h = native.row_hash([k])
    for i, v in enumerate(k):
        expect = (31 * 1 + native.murmur3_32(
            v.tobytes(), 0)) & 0xFFFFFFFF
        assert h[i] == expect


def test_row_hash_multi_column_combiner():
    a = np.array([7, 7], dtype=np.int64)
    b = np.array([1, 2], dtype=np.float64)
    h = native.row_hash([a, b])
    assert h[0] != h[1]  # second column distinguishes
    h0 = 31 * 1 + native.murmur3_32(a[0].tobytes(), 0)
    h0 = (31 * h0 + native.murmur3_32(b[0].tobytes(), 0)) & 0xFFFFFFFF
    assert h[0] == h0 & 0xFFFFFFFF


def test_row_hash_string_column():
    mat = np.zeros((3, 8), np.uint8)
    for i, s in enumerate([b"ab", b"abc", b"ab"]):
        mat[i, : len(s)] = np.frombuffer(s, np.uint8)
    lens = np.array([2, 3, 2], np.int32)
    h = native.row_hash([mat], [lens])
    assert h[0] == h[2] and h[0] != h[1]
    assert h[0] == (31 + native.murmur3_32(b"ab", 0)) & 0xFFFFFFFF


def test_partition_targets_histogram():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 1 << 32, 10_000, dtype=np.uint32)
    for world in (3, 4):  # modulo and power-of-two mask paths
        t, hist = native.partition_targets(h, world)
        assert hist.sum() == len(h)
        assert (t < world).all()
        np.testing.assert_array_equal(np.bincount(t, minlength=world), hist)
        np.testing.assert_array_equal(t, h % world)


def _hash_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 5003
    mat = rng.integers(0, 256, (n, 16)).astype(np.uint8)
    lens = rng.integers(0, 17, n).astype(np.int32)
    mat[np.arange(16)[None, :] >= lens[:, None]] = 0
    return [rng.integers(-2**62, 2**62, n), rng.random(n),
            rng.integers(0, 2**31, n).astype(np.int32),
            rng.random(n).astype(np.float32), rng.random(n) < 0.5,
            mat], [None, None, None, None, None, lens]


@pytest.mark.parametrize("cols", [[0], [1], [2, 3], [4], [5], [0, 5, 1],
                                  [0, 1, 2, 3, 4, 5]])
def test_row_hash_equals_the_reference_library(cols):
    arrays, lengths = _hash_inputs(11)
    arrays = [arrays[i] for i in cols]
    lengths = [lengths[i] for i in cols]
    got = native.row_hash(arrays, lengths)
    np.testing.assert_array_equal(got, rnative.row_hash(arrays, lengths))


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7, 8, 64])
def test_partition_targets_equal_the_reference_library(world):
    h = native.row_hash(*_hash_inputs(12))
    got_t, got_h = native.partition_targets(h, world)
    want_t, want_h = rnative.partition_targets(h, world)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_h, want_h)


# -- CSV --------------------------------------------------------------------

def test_csv_inference_and_nulls(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text('i,f,b,s\n1,1.5,true,x\n2,NA,false,"a,b"\nNA,3.5,true,NA\n')
    names, cols = native.csv_read(str(p), strings_can_be_null=True)
    assert names == ["i", "f", "b", "s"]
    i, f, b, s = cols
    assert i["data"].dtype == np.int64
    np.testing.assert_array_equal(i["validity"], [True, True, False])
    assert f["data"].dtype == np.float64
    np.testing.assert_array_equal(f["validity"], [True, False, True])
    assert b["data"].dtype == bool
    np.testing.assert_array_equal(b["data"], [True, False, True])
    got = [bytes(r[:n]) for r, n in zip(s["data"], s["lengths"])]
    assert got[:2] == [b"x", b"a,b"]
    np.testing.assert_array_equal(s["validity"], [True, True, False])


def test_csv_strings_not_null_by_default(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("s\nx\nNA\n")
    _, cols = native.csv_read(str(p))
    assert cols[0]["validity"].all()  # "NA" stays a string


def test_csv_matches_pyarrow_path(tmp_path, pctx):
    """Golden check: native ingest == pyarrow ingest at the Table level."""
    rng = np.random.default_rng(3)
    df = pd.DataFrame({
        "a": rng.integers(-100, 100, 200),
        "b": rng.random(200),
        "c": [f"s{i % 13}" for i in range(200)],
    })
    p = tmp_path / "t.csv"
    df.to_csv(p, index=False)
    t_native = Table.from_csv(p, ctx=pctx)
    with knob_env(CYLON_TPU_NO_NATIVE_IO="1"):
        t_arrow = Table.from_csv(p, ctx=pctx)
    pd.testing.assert_frame_equal(t_native.to_pandas(), t_arrow.to_pandas())


def test_csv_write_roundtrip(tmp_path, pctx):
    df = pd.DataFrame({
        "x": np.array([1, 2, 3], np.int64),
        "y": [0.1, 0.2, 0.30000000000000004],
        "s": ["plain", 'quo"te', "com,ma"],
    })
    t = Table.from_pandas(df, ctx=pctx)
    out = tmp_path / "o.csv"
    t.to_csv(out)
    pd.testing.assert_frame_equal(pd.read_csv(out), df)


def test_csv_no_header_and_skip_rows(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("# banner\n1,2\n3,4\n")
    names, cols = native.csv_read(str(p), has_header=False, skip_rows=1)
    assert names == ["f0", "f1"]
    np.testing.assert_array_equal(cols[0]["data"], [1, 3])
    np.testing.assert_array_equal(cols[1]["data"], [2, 4])


CSV_CASES = {
    "mixed": 'i,f,b,s\n1,1.5,true,x\n2,NA,false,"a,b"\nNA,3.5,true,NA\n',
    "quoted": 'k,s\n1,"he said ""hi"""\n2,"multi\nline"\n3,plain\n',
    "wide": "k,s\n1," + "w" * 300 + "\n2,\n",
    "floats": "f\n0.1\n-0.0\n1e308\n-1e-308\nnan\ninf\n3\n",
    "header_only": "a,b\n",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("nullable", [False, True])
def test_csv_read_equals_the_reference_library(tmp_path, case, nullable):
    p = tmp_path / "t.csv"
    p.write_text(CSV_CASES[case])
    names, cols = native.csv_read(p, strings_can_be_null=nullable)
    rnames, rcols = rnative.csv_read(p, strings_can_be_null=nullable)
    assert names == rnames
    for c, r in zip(cols, rcols):
        assert sorted(c) == sorted(r)
        for key in c:
            assert c[key].dtype == r[key].dtype, key
            np.testing.assert_array_equal(c[key], r[key])


# -- memory pool --------------------------------------------------------------

def test_memory_pool_accounting():
    pool = native.MemoryPool()
    p1 = pool.allocate(1000)
    p2 = pool.allocate(24)
    assert pool.bytes_allocated == 1024
    assert pool.max_memory == 1024
    assert pool.num_allocations == 2
    pool.free(p1)
    assert pool.bytes_allocated == 24
    assert pool.max_memory == 1024
    pool.free(p2)
    assert pool.bytes_allocated == 0
    pool.close()


# -- builder + registry (foreign-binding surface) -----------------------------

def test_builder_registry_roundtrip():
    native.builder_begin("reg_t1")
    native.builder_add_column("reg_t1", "k", np.arange(10, dtype=np.int64))
    native.builder_add_column("reg_t1", "v", np.linspace(0, 1, 10),
                              validity=np.arange(10) % 2 == 0)
    native.builder_finish("reg_t1")
    try:
        assert native.registry_contains("reg_t1")
        assert "reg_t1" in native.registry_ids()
        names, cols = native.registry_get("reg_t1")
        assert names == ["k", "v"]
        np.testing.assert_array_equal(cols[0]["data"], np.arange(10))
        np.testing.assert_array_equal(cols[1]["validity"],
                                      np.arange(10) % 2 == 0)
    finally:
        assert native.registry_remove("reg_t1")
    assert not native.registry_contains("reg_t1")


def test_builder_row_count_mismatch_rejected():
    native.builder_begin("reg_bad")
    native.builder_add_column("reg_bad", "a", np.arange(5))
    with pytest.raises(RuntimeError):
        native.builder_add_column("reg_bad", "b", np.arange(6))
    native.builder_finish("reg_bad")
    native.registry_remove("reg_bad")


def test_registry_string_column():
    mat = np.zeros((2, 8), np.uint8)
    mat[0, :2] = np.frombuffer(b"hi", np.uint8)
    mat[1, :3] = np.frombuffer(b"bye", np.uint8)
    native.builder_begin("reg_s")
    native.builder_add_column("reg_s", "s", mat,
                              lengths=np.array([2, 3], np.int32))
    native.builder_finish("reg_s")
    try:
        _, cols = native.registry_get("reg_s")
        got = [bytes(r[:n]) for r, n in zip(cols[0]["data"],
                                            cols[0]["lengths"])]
        assert got == [b"hi", b"bye"]
    finally:
        native.registry_remove("reg_s")


def test_csv_long_field_not_truncated(tmp_path):
    """Fields longer than any fixed scratch size read back intact."""
    big = "x" * 5000
    p = tmp_path / "long.csv"
    p.write_text(f"k,s\n1,{big}\n2,yy\n")
    _, cols = native.csv_read(p)
    lens = cols[1]["lengths"]
    assert int(lens[0]) == 5000
    assert bytes(cols[1]["data"][0][:5000]) == big.encode()


def test_csv_long_quoted_field_unescaped(tmp_path):
    big = 'ab""' * 2000  # unescapes to 6000 chars
    p = tmp_path / "longq.csv"
    p.write_text(f'k,s\n1,"{big}"\n')
    _, cols = native.csv_read(p)
    assert int(cols[1]["lengths"][0]) == 6000
    assert bytes(cols[1]["data"][0][:6]) == b'ab"ab"'


def test_csv_header_only(tmp_path):
    p = tmp_path / "empty.csv"
    p.write_text("a,b,c\n")
    names, cols = native.csv_read(p)
    assert names == ["a", "b", "c"]
    assert all(len(c["data"]) == 0 for c in cols)


def test_header_only_table(tmp_path, pctx):
    p = tmp_path / "empty2.csv"
    p.write_text("a,b\n")
    t = Table.from_csv(p, ctx=pctx)
    assert t.row_count == 0
    assert t.column_names == ["a", "b"]


# -- second-language hosts over the C ABI ------------------------------------

def _link_args():
    """Compiler arguments that link the port's library by its path (its
    name carries the sources' hash) with an rpath to its directory."""
    lib = native_build.build()
    return [f"-I{INCLUDE}", str(lib), f"-Wl,-rpath,{lib.parent}"]


def test_c_consumer_builds_and_reads(tmp_path):
    """A C host drives the registry + builder through the published C ABI
    header (``examples/c_consumer``), linked against the port's library."""
    exe = tmp_path / "consumer"
    cc = os.environ.get("CC", "gcc")
    compile_proc = subprocess.run(
        [cc, "-O2", "-std=c11", "-o", str(exe),
         str(EXAMPLES / "c_consumer" / "consumer.c"), *_link_args()],
        capture_output=True, text=True)
    assert compile_proc.returncode == 0, compile_proc.stderr
    run_proc = subprocess.run([str(exe)], capture_output=True, text=True,
                              timeout=60)
    assert run_proc.returncode == 0, run_proc.stdout + run_proc.stderr
    assert "ALL PASS" in run_proc.stdout


def test_perl_consumer_builds_and_reads(tmp_path):
    """A Perl 5 host drives the registry + builder through the C ABI via
    compiled XS glue (``examples/perl_consumer``), against the port's
    library."""
    perl = shutil.which("perl")
    if not perl:
        pytest.skip("no perl on this image")
    ccopts = subprocess.run([perl, "-MExtUtils::Embed", "-e", "ccopts"],
                            capture_output=True, text=True)
    if ccopts.returncode != 0:
        pytest.skip("perl without ExtUtils::Embed (no CORE headers)")
    srcdir = EXAMPLES / "perl_consumer"
    sodir = tmp_path / "auto" / "CylonTPU"
    sodir.mkdir(parents=True)
    cc = os.environ.get("CC", "gcc")
    compile_proc = subprocess.run(
        [cc, "-shared", "-fPIC", *ccopts.stdout.split(),
         str(srcdir / "CylonTPU.c"), *_link_args(),
         "-o", str(sodir / "CylonTPU.so")],
        capture_output=True, text=True)
    assert compile_proc.returncode == 0, compile_proc.stderr
    run_proc = subprocess.run(
        [perl, f"-I{tmp_path}", str(srcdir / "consumer.pl")],
        capture_output=True, text=True, timeout=60)
    assert run_proc.returncode == 0, run_proc.stdout + run_proc.stderr
    assert "ALL PASS" in run_proc.stdout


def test_jvm_consumer_builds_and_reads(tmp_path):
    """A JVM host over Panama FFM (``examples/jvm_consumer``) against the
    port's library; it skips where no JDK 22+ exists, as the reference's
    test does."""
    javac = shutil.which("javac")
    java = shutil.which("java")
    if not javac or not java:
        pytest.skip("no JDK on this image")
    ver = subprocess.run([java, "-version"], capture_output=True, text=True)
    m = re.search(r'version "(\d+)', ver.stderr + ver.stdout)
    if not m or int(m.group(1)) < 22:
        pytest.skip("JDK 22+ required for final java.lang.foreign")
    lib = native_build.build()
    src = EXAMPLES / "jvm_consumer" / "CylonTpuSmoke.java"
    compile_proc = subprocess.run([javac, "-d", str(tmp_path), str(src)],
                                  capture_output=True, text=True)
    assert compile_proc.returncode == 0, compile_proc.stderr
    run_proc = subprocess.run(
        [java, "--enable-native-access=ALL-UNNAMED",
         f"-Dcylon.native={lib}", "-cp", str(tmp_path), "CylonTpuSmoke"],
        capture_output=True, text=True, timeout=120)
    assert run_proc.returncode == 0, run_proc.stdout + run_proc.stderr
    assert "CHECKS PASSED" in run_proc.stdout
