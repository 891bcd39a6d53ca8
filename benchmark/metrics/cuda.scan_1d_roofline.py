"""Share of its memory bound that ``ops.scan.scan_1d`` reaches at the
length and dtype the sort join of ``join-groupby-2p28`` passes to it:
int32, 2^29 elements (both sides' 2^28 rows, the combined sort's length;
read from the path on the CPU at 2^12 rows per side, where it is 2^13).
Timed with CUDA events over ``REPS`` launches after a warm-up, on 4 GiB
that no cache holds.  Bound: 8 B per element (read once, write once) over
3.35 TB/s, the H100 SXM's HBM3 (NVIDIA's data sheet, at 700 W: the
harness logs the card's power limit)."""

N = 1 << 29
BYTES_PER_ELEMENT = 8
HBM_BYTES_PER_S = 3.35e12
REPS = 20


def read(run, token=None):
    import torch

    from cylon_tpu_torch.ops import scan

    if torch.device(run.device).type != "cuda":
        return None
    g = torch.Generator(device=run.device)
    g.manual_seed(0)
    x = torch.randint(0, 1 << 10, (N,), generator=g, device=run.device,
                      dtype=torch.int32)
    scan.scan_1d(x, "sum")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        scan.scan_1d(x, "sum")
    stop.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(stop) / 1e3 / REPS
    del x
    return 100.0 * BYTES_PER_ELEMENT * N / HBM_BYTES_PER_S / seconds
