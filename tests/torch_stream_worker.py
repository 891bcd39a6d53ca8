"""Worker for the port's streaming crash-resume test (NOT a pytest
module): the counterpart of ``tests/stream_worker.py`` on
``cylon_tpu_torch`` (the CPU device), with the same three micro-batches.

* ``--append-only`` with a killhard fault plan in the environment
  (``journal_commit@3=killhard``): the process dies INSIDE the third
  append's spill/manifest window.
* the full run in a FRESH process: the committed appends replay as
  no-ops from the journal, the torn third lands as a new batch, and the
  query refreshes after every append.

Writes the final refresh frame (npz) and a stats JSON (per refresh:
``parts_run``, ``partial_rows``, ``plan_cache_miss``, ``rows_delta``).

Usage: python -m tests.torch_stream_worker <out.npz> <stats.json>
       [--append-only]
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cylon_tpu_torch import CylonContext  # noqa: E402
from cylon_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from cylon_tpu_torch.stream import GroupByQuery, StreamTable  # noqa: E402

ROWS = 16  # same-shaped batches: the refresh builds no new callable


def batches():
    """The reference worker's three micro-batches, value for value."""
    rng = np.random.default_rng(19)
    return [{"k": rng.integers(0, 6, ROWS).astype(np.int64),
             "v": rng.random(ROWS)} for _ in range(3)]


def main() -> int:
    out_path, stats_path = sys.argv[1], sys.argv[2]
    append_only = "--append-only" in sys.argv[3:]
    s = StreamTable("killhard-stream")
    if append_only:
        for b in batches():
            s.append(b)  # the fault plan kills us inside one of these
        return 0
    q = None
    frame = None
    per_refresh = []
    for b in batches():
        s.append(b)
        if q is None:  # queries need the schema the first append fixes
            q = GroupByQuery(s, ["k"], {"v": ["sum", "mean", "count"]},
                             ctx=CylonContext.Init("cpu"))
        miss0 = obs_metrics.counter_value("plan_cache.miss")
        delta0 = obs_metrics.counter_value("stream.rows_delta")
        frame, stats = q.refresh()
        per_refresh.append({
            "watermark": stats["watermark"], "mode": stats["mode"],
            "parts_run": stats["parts_run"],
            "partial_rows": stats["partial_rows"],
            "passes_skipped": stats["passes_skipped"],
            "plan_cache_miss": obs_metrics.counter_value("plan_cache.miss")
            - miss0,
            "rows_delta": obs_metrics.counter_value("stream.rows_delta")
            - delta0,
        })
    np.savez(out_path, **{k: np.asarray(v) for k, v in frame.items()})
    with open(stats_path, "w", encoding="utf-8") as fh:
        json.dump({"refreshes": per_refresh,
                   "watermark": s.watermark,
                   "batch_rows": s.batch_rows(),
                   "batches_appended": obs_metrics.counter_value(
                       "stream.batches_appended")}, fh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
