"""OpenMetrics / Prometheus text exposition of the metrics registry.

A copy of ``cylon_tpu/obs/openmetrics.py``:

- :func:`render`: counters (``_total`` suffix), gauges and cumulative
  ``le``-bucket histograms (``_bucket``/``_sum``/``_count``) of one
  process's snapshot, names mangled ``shuffle.bytes_sent`` ->
  ``cylon_tpu_shuffle_bytes_sent_total`` (the reference's metric names,
  so one dashboard reads both packages) and bracketed tenant keys
  (``serve.run_ms[t]``) lifted into a ``tenant`` label;
- :func:`render_fleet`: the same over per-rank snapshots, every sample
  labeled ``rank="N"``;
- :func:`start_server` / :func:`ensure_server`: a stdlib ``http.server``
  listener (``CYLON_TPU_METRICS_PORT``) answering ``GET /metrics`` with a
  fresh render per scrape; the query service starts the knob-driven one;
- :func:`parse`: a small validating parser of the exposition text
  (``# TYPE`` tracking, sample shape, cumulative-bucket monotonicity).

Host-side stdlib only: a scrape reads host dicts and never touches the
device.
"""
from __future__ import annotations

import logging
import re
import threading
from typing import Dict, List, Optional, Tuple

from .. import config
from . import metrics as metrics_mod

log = logging.getLogger("cylon_tpu_torch")

PREFIX = "cylon_tpu_"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def metrics_port() -> int:
    """``CYLON_TPU_METRICS_PORT``: the per-process scrape port;
    0 (default) disables the listener."""
    return int(config.knob("CYLON_TPU_METRICS_PORT"))


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


#: the label-pair bracket grammar: ``name=value`` pairs, names are
#: exposition-legal identifiers, values exclude the reserved ``, =``
#: (writers remap them)
_LABEL_PAIRS = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*=[^,=]*(?:,[a-zA-Z_][a-zA-Z0-9_]*=[^,=]*)*$")


def _split_label(key: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Lift the bracketed labels out of a registry key.  Two grammars:

    - the tenant form ``serve.run_ms[acme]`` -> one ``tenant`` label
      (the bracket body is the tenant id, arbitrary bytes);
    - the pair form ``router.requests_routed[tenant=a,replica=1]``
      -> explicit labels, accepted ONLY for ``router.``-prefixed keys
      (a serve tenant literally named ``x=y`` must keep rendering as a
      tenant, not sprout an ``x`` label)."""
    if key.endswith("]") and "[" in key:
        base, _, rest = key.partition("[")
        body = rest[:-1]
        if base.startswith("router.") and _LABEL_PAIRS.match(body):
            return base, [tuple(p.split("=", 1))  # type: ignore[misc]
                          for p in body.split(",")]
        return base, [("tenant", body)]
    return key, []


def metric_name(key: str, *, counter: bool = False) -> str:
    """Registry key -> exposition metric name: ``cylon_tpu_`` prefix,
    dots and every other illegal character to ``_``, counters get the
    conventional ``_total`` suffix."""
    name = PREFIX + _SANITIZE.sub("_", key)
    if counter and not name.endswith("_total"):
        name += "_total"
    assert _NAME_OK.match(name), name
    return name


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in pairs) + "}"


def _num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _render_into(lines: List[str], snapshot: Dict,
                 extra_labels: List[Tuple[str, str]],
                 typed: Dict[str, str]) -> None:
    """Append one snapshot's samples, emitting each metric's ``# TYPE``
    header exactly once across the whole document (``typed`` is the
    name -> kind memo shared between ranks of a fleet render)."""

    def head(name: str, kind: str) -> None:
        if name not in typed:
            typed[name] = kind
            lines.append(f"# TYPE {name} {kind}")

    for key in sorted(snapshot.get("counters") or {}):
        base, pairs = _split_label(key)
        name = metric_name(base, counter=True)
        head(name, "counter")
        lab = list(extra_labels) + pairs
        lines.append(f"{name}{_labels(lab)} "
                     f"{_num((snapshot['counters'])[key])}")
    for key in sorted(snapshot.get("gauges") or {}):
        base, pairs = _split_label(key)
        name = metric_name(base)
        head(name, "gauge")
        lab = list(extra_labels) + pairs
        lines.append(f"{name}{_labels(lab)} "
                     f"{_num((snapshot['gauges'])[key])}")
    for key in sorted(snapshot.get("histograms") or {}):
        h = (snapshot["histograms"])[key]
        base, pairs = _split_label(key)
        name = metric_name(base)
        head(name, "histogram")
        lab = list(extra_labels) + pairs
        le = h.get("le") or {}
        count = int(h.get("count", 0))
        if "+Inf" not in le:
            # a histogram recorded before the le buckets existed (an old
            # flight dump, a foreign snapshot): one +Inf bucket == count
            # keeps the exposition well-formed
            le = dict(le, **{"+Inf": count})
        for bound, n in sorted(
                le.items(),
                key=lambda kv: (float("inf") if kv[0] == "+Inf"
                                else float(kv[0]))):
            lines.append(f"{name}_bucket"
                         f"{_labels(lab + [('le', bound)])} {int(n)}")
        lines.append(f"{name}_sum{_labels(lab)} "
                     f"{_num(float(h.get('sum', 0.0)))}")
        lines.append(f"{name}_count{_labels(lab)} {count}")


def _pkg_version() -> str:
    """The package version for the build-info gauge, resolved lazily so
    this module never imports the (heavy) package root."""
    import sys as _sys

    v = getattr(_sys.modules.get("cylon_tpu_torch"), "__version__", None)
    return str(v) if v else "unknown"


def _append_build_info(lines: List[str], typed: Dict[str, str],
                       extra_labels: List[Tuple[str, str]]) -> None:
    """The ``cylon_tpu_build_info`` info-style gauge (value always 1;
    identity rides the labels): version, rank and the last-observed
    coordinator incarnation (-1 without one)."""
    from . import export as export_mod
    from . import fleet as fleet_mod

    name = PREFIX + "build_info"
    if name not in typed:
        typed[name] = "gauge"
        lines.append(f"# TYPE {name} gauge")
    inc = fleet_mod.current_incarnation()
    lab = list(extra_labels) + [
        ("version", _pkg_version()),
        ("rank", str(fleet_mod.current_rank()
                     if fleet_mod.current_rank() is not None
                     else export_mod.default_rank())),
        ("incarnation", str(inc if inc is not None else -1)),
    ]
    lines.append(f"{name}{_labels(lab)} 1")


#: counters a scrape must ALWAYS see, zero-valued before first increment:
#: the tail-retention pair and the streaming ingest pair, so a dashboard
#: tells "nothing closed or appended yet" (zeros) from a broken deploy
#: (the counters missing)
_ALWAYS_COUNTERS = ("trace.tail_kept", "trace.tail_dropped",
                    "stream.batches_appended", "stream.rows_delta")


def _with_always_counters(snap: Dict) -> Dict:
    counters = dict(snap.get("counters") or {})
    if all(k in counters for k in _ALWAYS_COUNTERS):
        return snap
    return {**snap,
            "counters": {**{k: 0 for k in _ALWAYS_COUNTERS}, **counters}}


def render(snapshot: Optional[Dict] = None) -> str:
    """One process's metrics snapshot as exposition text (terminated by
    the OpenMetrics ``# EOF`` marker, which Prometheus' text parser
    treats as a comment).  Always carries the ``cylon_tpu_build_info``
    identity gauge and the ``trace.tail_kept``/``trace.tail_dropped``
    retention pair, even over an empty registry."""
    snap = _with_always_counters(
        metrics_mod.snapshot() if snapshot is None else snapshot)
    lines: List[str] = []
    typed: Dict[str, str] = {}
    _append_build_info(lines, typed, [])
    _render_into(lines, snap, [], typed)
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_fleet(snapshots: Dict[str, Dict]) -> str:
    """Per-rank snapshots (the coordinator's heartbeat-shipped ledger)
    as ONE exposition document, every sample labeled ``rank``.  Ranks
    render in sorted order; each metric's ``# TYPE`` appears once.
    Carries the same always-on surface as :func:`render`: the rendering
    process's ``build_info`` identity gauge (per-rank versions are not
    shipped over heartbeats — the coordinator's identity stands in) and
    the zero-valued retention counter pair PER RANK, so the fleet
    scrape distinguishes "no requests closed on rank N" from a broken
    deploy exactly like the per-process one."""
    lines: List[str] = []
    typed: Dict[str, str] = {}
    _append_build_info(lines, typed, [])
    for rank in sorted(snapshots, key=str):
        _render_into(lines, _with_always_counters(snapshots[rank] or {}),
                     [("rank", str(rank))], typed)
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# validating parser
# ---------------------------------------------------------------------------

# label values are QUOTED strings that may legally contain '}' and
# escaped quotes (tenant ids are arbitrary) — the label block must be
# matched as a sequence of quoted pairs, never as "anything up to the
# first '}'" (which broke render->parse roundtrip on a tenant "a}b")
_LABEL_PAIR = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{(?:" + _LABEL_PAIR + r")?(?:," + _LABEL_PAIR + r")*\})?"
    r"\s+(?P<value>\S+)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESC = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    return _UNESC.sub(lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)


def parse(text: str) -> Dict[str, Dict]:
    """Validate exposition text and return
    ``{metric name: {"type": kind, "samples": [(labels dict, value)]}}``
    (bucket/sum/count samples attach to their histogram's base name).
    Raises ``ValueError`` on malformed lines, samples preceding their
    ``# TYPE``, a missing ``# EOF``, or non-monotone cumulative
    buckets."""
    out: Dict[str, Dict] = {}
    saw_eof = False
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if saw_eof:
            raise ValueError(f"line {ln}: content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                name, kind = parts[2], parts[3]
                if kind not in ("counter", "gauge", "histogram"):
                    raise ValueError(f"line {ln}: unknown type {kind!r}")
                if name in out:
                    raise ValueError(f"line {ln}: duplicate TYPE for {name}")
                out[name] = {"type": kind, "samples": []}
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in out \
                    and out[name[: -len(suffix)]]["type"] == "histogram":
                base = name[: -len(suffix)]
                break
        if base not in out:
            raise ValueError(f"line {ln}: sample {name!r} precedes its "
                             f"# TYPE header")
        labels = {k: _unescape(v)
                  for k, v in _LABEL.findall(m.group("labels") or "")}
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(f"line {ln}: bad value {m.group('value')!r}"
                             ) from e
        out[base]["samples"].append((name, labels, value))
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    for name, rec in out.items():
        if rec["type"] != "histogram":
            continue
        # cumulative-bucket monotonicity per label set (minus `le`)
        series: Dict[tuple, List[Tuple[float, float]]] = {}
        for sname, labels, value in rec["samples"]:
            if not sname.endswith("_bucket"):
                continue
            le = labels.get("le")
            if le is None:
                raise ValueError(f"{sname}: bucket sample without le")
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            bound = float("inf") if le == "+Inf" else float(le)
            series.setdefault(key, []).append((bound, value))
        for key, pts in series.items():
            pts.sort()
            vals = [v for _, v in pts]
            if vals != sorted(vals):
                raise ValueError(f"{name}{dict(key)}: non-monotone "
                                 f"cumulative buckets {vals}")
            if pts and pts[-1][0] != float("inf"):
                raise ValueError(f"{name}{dict(key)}: missing +Inf bucket")
    return out


# ---------------------------------------------------------------------------
# the scrape listener
# ---------------------------------------------------------------------------

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Tiny stdlib HTTP listener answering ``GET /metrics`` (and ``/``)
    with a fresh :func:`render` per scrape.  Daemon-threaded; binding
    port 0 takes an ephemeral port (``.port`` reports it)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler API)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                log.debug("openmetrics: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"cylon-openmetrics-{self.port}")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


_lock = threading.Lock()
_server: Optional[MetricsServer] = None


def start_server(port: int, host: str = "127.0.0.1") -> MetricsServer:
    """Start a listener on an explicit port (0 = ephemeral).  The caller
    owns the returned server (tests, scripts); :func:`ensure_server` is
    the knob-driven singleton path."""
    return MetricsServer(port, host)


def ensure_server() -> Optional[MetricsServer]:
    """Start (once per process) the knob-driven scrape listener when
    ``CYLON_TPU_METRICS_PORT`` > 0; None when disabled or the bind
    failed (an occupied port must never fail the context bringing the
    listener up — scraping is an observability extra, warned and
    skipped)."""
    global _server
    port = metrics_port()
    if port <= 0:
        return None
    with _lock:
        if _server is not None:
            return _server
        try:
            _server = start_server(port)
        except OSError as e:
            log.warning("openmetrics: cannot bind scrape port %d (%s: %s); "
                        "metrics listener disabled for this process",
                        port, type(e).__name__, e)
            return None
        log.info("openmetrics: serving /metrics on %s:%d",
                 _server.host, _server.port)
        return _server


def stop_server() -> None:
    """Stop the singleton listener (tests)."""
    global _server
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
