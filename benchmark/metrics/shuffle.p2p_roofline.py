"""Share of the link between cards that the exchange's copies from one
card to another reach: for each card, the bytes of its peer-to-peer
copies in the trace of the traced queries (``Memcpy PtoP`` events, each
with the profiler's ``bytes`` argument) over the link's peak times those
copies' seconds, and the mean over the cards that made such copies.
Where an event lacks its bytes, the program's ``shuffle.bytes_cross``
counter over the traced queries stands for the bytes of all of them,
over the peak times all their seconds.

The peak is NVLink 4's 450 GB/s a direction, the H100 SXM's (NVIDIA's
data sheet): on the benchmark's four-card machine ``nvidia-smi nvlink
--status`` lists 18 active links on every card, ``nvidia-smi topo -p2p
n`` reads OK between every pair, and ``torch.cuda.can_device_access_peer``
is true for every pair (``nvidia-smi topo -m`` fails there).

The trace's events are taken where the harness reduces them: ``begin``
wraps ``benchmark.trace.reduce`` to keep the copies' events, and
``read`` puts it back."""
from types import SimpleNamespace

from benchmark import harness, trace

LINK_BYTES_PER_S = 450e9
MARK = "PtoP"
_cross = harness.reader("shuffle.cross_gib")


def _copies(events: list) -> list:
    """(card, bytes or None, seconds) of each peer-to-peer copy."""
    out = []
    for e in events:
        if e.get("ph") != "X" or MARK not in str(e.get("name", "")) \
                or str(e.get("cat", "")).lower() not in ("gpu_memcpy",
                                                         "memcpy"):
            continue
        args = e.get("args") or {}
        nbytes = args.get("bytes")
        out.append((int(args.get("device", 0)),
                    None if nbytes is None else float(nbytes),
                    float(e.get("dur", 0)) * 1e-6))
    return out


def begin(run):
    token = SimpleNamespace(reduce=trace.reduce, copies=None,
                            cross=_cross.begin(run))

    def reduce(events, *args, **kwargs):
        token.copies = _copies(events)
        return token.reduce(events, *args, **kwargs)

    trace.reduce = reduce
    return token


def read(run, token=None):
    if token is None:
        return None
    trace.reduce = token.reduce
    copies = [c for c in token.copies or () if c[2] > 0]
    if not copies:
        return None
    if any(nbytes is None for _, nbytes, _ in copies):
        gib = _cross.read(run, token.cross)
        if gib is None:
            return None
        seconds = sum(s for _, _, s in copies) / run.trace.queries
        return 100.0 * gib * 2 ** 30 / LINK_BYTES_PER_S / seconds
    cards = {}
    for card, nbytes, seconds in copies:
        b, s = cards.get(card, (0.0, 0.0))
        cards[card] = (b + nbytes, s + seconds)
    return sum(100.0 * b / LINK_BYTES_PER_S / s
               for b, s in cards.values()) / len(cards)
