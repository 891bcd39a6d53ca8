"""Time variants of ``scan_1d``'s look-back kernel on the card.

    python -m cylon_tpu_torch.cuda.scan_variants [--out PATH]

Each variant is ``cuda/scan.cu`` with a few lines replaced (``VARIANTS``),
compiled by ``nvcc`` with the package's flags into
``build/cylon_tpu_torch/variants/`` (all builds started together), checked
bit for bit against the plain version, and timed with CUDA events at the
main path's shapes: the int32 sum, max and reversed min at 2^27 and 2^26
elements.  The variants run in turns, forward then backward, so that drift
on the card falls on all of them alike.  Prints the card's name and power
limit, then one JSON line per variant, and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# name -> (source text, replacement); "base" is the source as it stands
VARIANTS = {
    "base": (),
    "acquire_release": (("ld.relaxed.gpu.b64", "ld.acquire.gpu.b64"),
                        ("st.relaxed.gpu.b64", "st.release.gpu.b64")),
    # status words 8 bytes apart instead of one 128-byte line each
    "stride1": (("constexpr int kStatusStride = 16;",
                 "constexpr int kStatusStride = 1;"),),
    # 8192-element tiles: 8 vectors a data thread, or 16 data warps
    "vecs8": (("constexpr int kVecs = 4;", "constexpr int kVecs = 8;"),),
    "threads512": (("constexpr int kLbThreads = 256;",
                    "constexpr int kLbThreads = 512;"),),
    # diagnostic, not checked: no look-back, so no carry across tiles; the
    # time of loading, scanning and storing the tiles alone
    "diag_no_lookback": (("const T excl = tile > 0 ? look_back<T, OP>("
                          "status, tile, lane)",
                          "const T excl = tile > 0 ? F::neutral()"),),
}
SHAPES = (1 << 27, 1 << 26)
CASES = (("sum", False), ("max", False), ("min", True))
_OP = {"sum": 0, "min": 1, "max": 2}


def _build(name: str, edits) -> str:
    from . import build

    src = (build._HERE / "scan.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in scan.cu")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"scan_{name}.cu", out / f"libscan_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    # registers of the look-back kernels, from ptxas -v
    lines = (proc.stdout + proc.stderr).splitlines()
    regs = [int(w) for i, line in enumerate(lines)
            if "lookback_scan_kernel" in line and "Compiling" in line
            for nxt in lines[i + 1:i + 4] if "registers" in nxt
            for w, after in zip(nxt.split(), nxt.split()[1:])
            if after == "registers,"]
    return str(so), max(regs, default=0)


def _scan(lib, x, op: str, rev: bool):
    import torch

    n = x.shape[0]
    out = torch.empty_like(x)
    scratch = torch.empty(lib.cts_scan_1d_scratch_words(n),
                          dtype=torch.int64, device=x.device)
    rc = lib.cts_scan_1d(0, _OP[op], x.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), n, int(rev),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scan_1d launch failed: CUDA error {rc}")
    return out


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    import torch

    from ..ops import scan

    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(_build, VARIANTS,
                                            VARIANTS.values())))
    libs = {}
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(path)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cts_scan_1d.argtypes = [i, i, vp, vp, vp, ll, i, vp]
        lib.cts_scan_1d.restype = i
        lib.cts_scan_1d_tile.restype = i
        lib.cts_scan_1d_scratch_words.argtypes = [ll]
        lib.cts_scan_1d_scratch_words.restype = ll
        lib.tile = lib.cts_scan_1d_tile()
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {name: {"tile": lib.tile, "registers": built[name][1]}
               for name, lib in libs.items()}
    for n in SHAPES:
        x = torch.randint(-(1 << 20), 1 << 20, (n,), generator=gen,
                          device="cuda", dtype=torch.int32)
        for op, rev in CASES:
            want = scan.scan_1d_plain(x, op, rev)
            for name, lib in libs.items():
                if not name.startswith("diag") and \
                        not torch.equal(_scan(lib, x, op, rev), want):
                    raise AssertionError(f"{name} {op} rev={rev} n={n} "
                                         "differs from plain")
            del want
            key = f"{op}{'_rev' if rev else ''}@{n}"
            order = list(libs) + list(libs)[::-1]
            for name in order:
                ms = _time_ms(lambda: _scan(libs[name], x, op, rev))
                results[name].setdefault(key, []).append(ms)
        # the same bytes through PyTorch's copy kernel: 4 B in, 4 B out
        y = torch.empty_like(x)
        results.setdefault("torch_copy", {})[f"copy@{n}"] = [
            _time_ms(lambda: y.copy_(x)) for _ in range(2)]
        del y
        bound = 8 * n / 3.35e12 * 1e3
        for r in results.values():
            r[f"bound@{n}"] = bound
        del x
    for name, r in results.items():
        print(json.dumps({"variant": name, **r}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
