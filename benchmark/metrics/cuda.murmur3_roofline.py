"""Share of its memory bound that the CUDA murmur3 hash-partition kernel
(``cuda/murmur3.cu``) reaches at the path's own lengths: 100 x the least
bytes the traced queries' launches must move (``ops.hash_kernels.BYTES``:
each key's data and validity read once, the hash and target written
once, 13 B a row for an int32 key) over 3.35 TB/s, the H100 SXM's HBM3
(NVIDIA's data sheet, at 700 W: the harness logs the card's power
limit), over the seconds the trace gives the kernel's family, summed over
the cards as the bytes are.  None where the program counts no bytes."""
HBM_BYTES_PER_S = 3.35e12
FAMILY = "CUDA hash kernel (cuda/murmur3.cu)"


def _total():
    from cylon_tpu_torch.ops import hash_kernels

    counted = getattr(hash_kernels, "BYTES", None)
    return None if counted is None else sum(counted.values())


def begin(run):
    return _total()


def read(run, token=None):
    total = _total()
    seconds = run.trace.families.get(FAMILY, 0.0) if run.trace else 0.0
    if token is None or total is None or total <= token or seconds <= 0:
        return None
    return 100.0 * (total - token) / HBM_BYTES_PER_S / seconds
