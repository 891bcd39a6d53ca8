"""The scan family (cylon_tpu_torch.ops.scan): its plain PyTorch versions
against the JAX package's Pallas scans (cylon_tpu.ops.pallas_scan, in
interpret mode, 256-lane blocks) on the same inputs.  The CUDA kernels
are held against the plain versions on the card by test_torch_gpu.py;
here the ctypes bindings are held against the CUDA sources.

Tolerances: exact for integers and for min/max; float32 sums rtol=1e-5,
the reference's own bound (tests/test_pallas_scan.py), because both sides
round in their own combine-tree order."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import pallas_scan
from cylon_tpu_torch.ops import hash_kernels, scan

SIZES = (1, 127, 129, 4096, 33000)
DTYPES = {"f32": np.float32, "i32": np.int32}


def _assert_match(got, exp, dt, op):
    got = got.numpy()
    assert got.dtype == exp.dtype
    if dt == np.float32 and op == "sum":
        np.testing.assert_allclose(got, exp, rtol=1e-5)  # float32 sum
    else:
        np.testing.assert_array_equal(got, exp)  # exact


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", scan.OPS)
def test_scan_1d_matches_pallas(op, dtype, reverse):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(17)
    for n in SIZES:
        x = (rng.random(n) * 1000 - 300).astype(dt)
        exp = np.asarray(pallas_scan.scan_1d(
            jnp.asarray(x), op, reverse=reverse, interpret=True,
            block_lanes=256))
        _assert_match(scan.scan_1d(torch.from_numpy(x), op, reverse), exp,
                      dt, op)


@pytest.mark.parametrize("dtype", sorted(DTYPES) + ["u32"])
@pytest.mark.parametrize("op", scan.OPS)
def test_segmented_scan_matches_pallas(op, dtype):
    dt = DTYPES.get(dtype, np.uint32)
    rng = np.random.default_rng(23)
    for n in SIZES:
        x = (rng.random(n) * 50).astype(dt)
        r = rng.random(n) < 0.02
        r[0] = True
        exp = np.asarray(pallas_scan.segmented_scan(
            jnp.asarray(x), jnp.asarray(r), op, interpret=True,
            block_lanes=256))
        got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                                  op)
        _assert_match(got, exp, dt, op)


@pytest.mark.parametrize("resets", ["none", "all"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_segmented_scan_no_resets_and_all_resets(resets, dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(29)
    n = 5000
    x = (rng.random(n) * 10).astype(dt)
    r = np.full(n, resets == "all")
    for op in scan.OPS:
        exp = np.asarray(pallas_scan.segmented_scan(
            jnp.asarray(x), jnp.asarray(r), op, interpret=True,
            block_lanes=256))
        got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                                  op)
        _assert_match(got, exp, dt, op)
        if resets == "all":
            np.testing.assert_array_equal(got.numpy(), x)  # identity


def test_uint32_plain_versions_wrap_and_order_as_unsigned():
    x = np.array([4294967290, 3, 7, 4294967295, 1], np.uint32)
    r = np.array([True, False, True, False, False])
    got = scan.scan_1d(torch.from_numpy(x), "sum").numpy()
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.uint32))
    got = scan.scan_1d(torch.from_numpy(x), "max", reverse=True).numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(x[::-1])[::-1])
    got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                              "min").numpy()
    np.testing.assert_array_equal(got, [4294967290, 3, 7, 7, 1])


def test_float_min_max_propagate_nan_like_reference():
    x = np.array([3.0, np.nan, 1.0, 5.0, -2.0], np.float32)
    r = np.array([True, False, False, True, False])
    for op in ("min", "max"):
        exp = np.asarray(pallas_scan.segmented_scan(
            jnp.asarray(x), jnp.asarray(r), op, interpret=True,
            block_lanes=256))
        got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                                  op).numpy()
        np.testing.assert_array_equal(got, exp)


# -- the ctypes bindings against the CUDA sources -----------------------------

CUDA_DIR = Path(scan.__file__).resolve().parent.parent / "cuda"


class _FakeFn:
    def __init__(self, answer):
        self.answer = answer
        self.argtypes = self.restype = None

    def __call__(self, *args):
        return self.answer


class _FakeLib:
    """Stands in for the loaded library: records what ``_declare`` sets on
    each function and answers calls with the values the source returns."""

    def __init__(self, answers):
        self.fns = {}
        self._answers = answers

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _FakeFn(self._answers.get(name)))


def _extern_c(source: str):
    """(functions, answers) of a CUDA source: every function defined in its
    ``extern "C"`` blocks as name -> (return type, parameter types), and
    each one whose body is ``return CONSTANT;`` -> that constant's value
    (``constexpr int`` and ``#define``)."""
    text = re.sub(r"//[^\n]*", "", source)
    consts = {}
    for name, value in re.findall(r"#define\s+(\w+)\s+(\d+)", text):
        consts[name] = int(value)
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        consts[name] = eval(expr.replace("/", "//"),  # integer arithmetic
                            {"__builtins__": {}}, dict(consts))
    fns, answers = {}, {}
    for m in re.finditer(r'extern "C"\s*\{', text):
        depth, i, top = 1, m.end(), []
        while depth:  # keep the block's own level, drop function bodies
            ch = text[i]
            depth += (ch == "{") - (ch == "}")
            if depth == 1 or (depth == 2 and ch == "{"):
                top.append(ch)
            i += 1
        body = text[m.end():i]
        for ret, name, params in re.findall(
                r"(?:^|[;}])\s*([A-Za-z_][\w\s]*?[\w*])\s*\b(\w+)\s*"
                r"\(([^()]*)\)\s*\{", "".join(top)):
            params = [" ".join(p.split()[:-1]) for p in params.split(",")
                      if p.strip() not in ("", "void")]
            fns[name] = (ret.strip(), params)
        for name, const in re.findall(
                r"int\s+(\w+)\(\)\s*\{\s*return\s+(\w+);\s*\}", body):
            answers[name] = consts[const]
    return fns, answers


def _ctype_of(c_type: str):
    if "*" in c_type:
        return (ctypes.c_void_p, ctypes._Pointer)
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[c_type]


def _matches(declared, c_type: str) -> bool:
    want = _ctype_of(c_type)
    if isinstance(want, tuple):
        return declared is want[0] or issubclass(declared, want[1])
    return declared is want


@pytest.mark.parametrize("source,module", [("scan.cu", scan),
                                           ("murmur3.cu", hash_kernels)],
                         ids=["scan", "murmur3"])
def test_ctypes_bindings_match_cuda_sources(source, module):
    """Every function ``_declare`` binds is defined in the source's
    ``extern "C"`` block with as many parameters, of matching kinds, and
    the same return type; every entry point is bound; constants the
    wrapper checks on load agree.  Without nvcc here, a renamed or
    re-shaped entry point would otherwise surface only on the card."""
    fns, answers = _extern_c((CUDA_DIR / source).read_text())
    lib = _FakeLib(answers)
    module._declare(lib)  # raises if a checked constant disagrees
    assert fns and set(lib.fns) == set(fns)
    for name, fn in lib.fns.items():
        ret, params = fns[name]
        assert fn.argtypes is not None and len(fn.argtypes) == len(params), \
            (name, fn.argtypes, params)
        for declared, c_type in zip(fn.argtypes, params):
            assert _matches(declared, c_type), (name, declared, c_type)
        assert _matches(fn.restype, ret), (name, fn.restype, ret)
