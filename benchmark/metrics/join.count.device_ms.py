"""Device milliseconds per traced query in the join's count pass: the
program's ``join.count`` span timed on the card (``obs.spans
.device_report``: stream time between a CUDA event at the span's entry
and one at its exit, so the pass's device work and any stream idle
inside it), over the traced queries."""

SPAN = "join.count"


def device_seconds(span: str):
    """The span's device seconds so far, or None where the program times
    no span on the device."""
    from cylon_tpu_torch.obs import spans

    report = getattr(spans, "device_report", None)
    return None if report is None else report().get(span, (0.0, 0))[0]


def per_query_ms(run, token, span: str):
    now = device_seconds(span)
    if token is None or now is None or not run.trace \
            or not run.trace.queries or now <= token:
        return None
    return 1e3 * (now - token) / run.trace.queries


def begin(run):
    return device_seconds(SPAN)


def read(run, token=None):
    return per_query_ms(run, token, SPAN)
