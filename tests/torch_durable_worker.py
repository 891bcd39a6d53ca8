"""Worker for the port's durable-execution crash-resume tests (not a
pytest module), the counterpart of ``tests/durable_worker.py``: runs one
deterministic chunked join -> group-by of ``cylon_tpu_torch`` on the CPU
with whatever ``CYLON_TPU_*`` knobs the parent put in the environment
(durable dir, fault plan) and writes the result + stats to the given
paths, so the parent can kill it mid-journal (the ``killhard`` fault kind
``os._exit``s from inside, which is indistinguishable from ``kill -9``)
and re-invoke it in a FRESH process to prove the journal resumes the run
bit-identically.  Imports neither jax nor the JAX package.

Usage: python tests/torch_durable_worker.py <out.npz> <stats.json> [seed]
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cylon_tpu_torch import CylonContext  # noqa: E402
from cylon_tpu_torch.exec import chunked_join_groupby_tables  # noqa: E402

N_ROWS = 4000
N_PASSES = 4


def inputs(seed: int):
    """Deterministic inputs: every invocation (killed, resumed, or
    uninterrupted) sees identical data, so the run fingerprint agrees."""
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, N_ROWS, N_ROWS).astype(np.int64),
            "a": rng.random(N_ROWS).astype(np.float32)}
    right = {"k": rng.integers(0, N_ROWS, N_ROWS).astype(np.int64),
             "b": rng.random(N_ROWS).astype(np.float32)}
    return left, right


def run(left, right):
    return chunked_join_groupby_tables(
        left, right, on="k", how="inner", group_by="l_k",
        agg={"a": ["sum"], "b": ["mean"]}, passes=N_PASSES, mode="hash",
        ctx=CylonContext.Init("cpu"))


def main() -> int:
    out_path, stats_path = sys.argv[1], sys.argv[2]
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 7
    res, stats = run(*inputs(seed))
    order = np.argsort(res["l_k"], kind="stable")
    np.savez(out_path, **{k: np.asarray(v)[order] for k, v in res.items()})
    with open(stats_path, "w", encoding="utf-8") as fh:
        json.dump({k: v for k, v in stats.items()
                   if isinstance(v, (int, float, str, list))}, fh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
