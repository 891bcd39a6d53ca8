"""Share of their memory bound that the CUDA scan kernels
(``cuda/scan.cu``) reach at the path's own lengths: 100 x the least
bytes the traced queries' scan launches must move (``ops.scan.BYTES``:
each input read once and each output written once at the dtype's size,
``segmented_scan``'s reset flags read once) over 3.35 TB/s, the H100
SXM's HBM3 (NVIDIA's data sheet, at 700 W: the harness logs the card's
power limit), over the seconds the trace gives the scan kernels' family.
The bytes are counted around each traced query alone: ``begin`` wraps
the cell's query for the trace and ``read`` unwraps it, so scans that
other readers launch are not counted."""
from benchmark import trace

HBM_BYTES_PER_S = 3.35e12
FAMILY = "CUDA scan kernels (cuda/scan.cu)"


class _Counted:
    """The cell's query module, with ``run`` adding the scan bytes each
    call launches to ``counted``."""

    def __init__(self, query, scan):
        self.query, self.counted = query, 0

        def run(state):
            before = sum(scan.BYTES.values())
            try:
                return query.run(state)
            finally:
                self.counted += sum(scan.BYTES.values()) - before

        self.run = run

    def __getattr__(self, name):
        return getattr(self.query, name)


def begin(run):
    from cylon_tpu_torch.ops import scan

    if getattr(scan, "BYTES", None) is None:
        return None
    run.cell.query = _Counted(run.cell.query, scan)
    return run.cell.query


def read(run, token=None):
    if token is None:
        return None
    run.cell.query = token.query
    seconds = run.trace.families.get(FAMILY, 0.0) if run.trace else 0.0
    if not token.counted or seconds <= 0:
        return None
    return 100.0 * token.counted / HBM_BYTES_PER_S / seconds
