#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cylon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--profile]

Phases, each of which fails the run on error:

1. the card's name and power limit, torch and CUDA versions; build every
   CUDA kernel from the sources in the checkout (one nvcc per source, all
   started together) and the host C++ library (``g++``, alongside), and
   print the build time;
2. every kernel against its plain PyTorch version on the card, at the
   main path's sizes and at ragged sizes: exact for integers and min/max,
   float32 sums within a stated tolerance of a float64 oracle; for
   ``scan_1d`` also its tile edges, every ``n % 4`` in both directions,
   misaligned views, 2^27 + 3 elements, and 20 repeated calls;
3. the single-chip main path at full size: 2^26 rows per side from
   ``pipeline.make_data(rows, 12345)``, join count -> ``cap_round`` ->
   ``join_groupby``, checked against a numpy ``bincount`` oracle; the
   launch counters are zeroed just before that run and read just after;
   then best-of-5 rows/s (``2*rows/seconds``, as ``bench.py``) and peak
   device memory;
3b. the distributed path at full size: the same data split into 4 shards
   of an in-process mesh on the one card, ``pipeline.distributed_tables``
   -> ``distributed_join_groupby`` (hash shuffle of both sides, per-shard
   join, two-phase group-by), counters zeroed just before and read just
   after, checked against the same oracle; best-of-5 rows/s, first-run
   time, peak device memory.  It is 4 shards on one card, not a
   multi-card number;
3c. HashPartition of the 2^26-row left table into 3 partitions: sizes
   sum to the rows, and every partition's keys re-hash to it under the
   plain version;
3d. the relational operators on the phase-3 tables as one-shard Tables
   (``pipeline.operator_calls``): sort by one and by two columns, unique
   (first, last), union / intersect / subtract of the key columns and
   union of whole rows, select, filter, sum / min / max / count, and the
   pipeline group-by of the key-sorted left table; each against a numpy
   oracle, with the counters zeroed just before its first run and read
   just after (a set op must launch ``scan_1d`` at least 6 times), then
   best-of-5 ms, rows/s and peak device memory;
3e. the distributed operators on the phase-3b tables
   (``pipeline.distributed_operator_calls``): range-partitioned sort,
   hash-shuffled unique and set ops (each launching the hash kernel at
   least 8 times), sum and min; the same checks and numbers;
3f. string keys on one shard: phase 3's data with each int key rendered
   as TPC-H's ``c_name`` (``"Customer#%09d"``, 18 bytes in the default
   32-byte column, byte matrices built with numpy digit arithmetic),
   ``pipeline.string_join_groupby`` against phase 3's oracle, group keys
   decoded on the card; counters zeroed around the first run; best-of-5
   rows/s and peak memory;
3g. the same in SHARDS shards: the join's and the group-by's shuffles hash
   the string key with ``ops/hashing.py`` (its device time in one run,
   bracketed by CUDA events, is printed), then ``distributed_sort`` by the
   string key, checked as monotone and a permutation of the input;
3h. TPC-H Q1 at SF10 (60,000,000 lineitem rows drawn as
   ``examples/tpch_data.py`` draws them, the flags CHAR(1) byte columns)
   on one shard and on SHARDS shards, against a numpy ``bincount`` oracle
   over the group codes.  On 3f-3h both scan kernels must launch and the
   hash kernel must not (every shuffle key is a string);
3k. the main path with the hash join: phase 3's tables through
   ``pipeline.join_count`` and ``pipeline.join_groupby`` with
   ``algo="hash"``; the join count must equal phase 3's, the groups
   (ordered by key) its oracle; counters zeroed just before the first run
   and read just after (both scan kernels must launch), the hash join's
   build and probe rounds, best-of-5 rows/s and peak device memory;
3l. the rest of the distributed surface on phase 3b's 4-shard tables,
   each case against numpy with the counters zeroed around its first run,
   first-run and best-of-3 times: (a) ``distributed_join(...,
   algorithm="hash")`` -> the SUM/MEAN group-by, against phase 3's
   oracle; (b) ``distributed_sort`` -> the pipeline group-by, equal to the
   hash group-by of the same table; (c) NUNIQUE; (d) the salted NUNIQUE
   (salt 4), equal to (c); (e) the pre-partitioned group-by of
   ``shuffle("k")``, equal to the shuffled path; (f) ``broadcast_gather``
   of a 2^20-row table: every shard holds every row in source-rank order.
   The hash kernel must launch in (a)-(e);
3t. the shuffle's three exchange realizations, each selected by setting
   ``CYLON_TPU_SHUFFLE_PACK`` / ``CYLON_TPU_SHUFFLE_COMPRESS`` in the
   environment around its calls: per buffer, one packed plane, the plane
   compressed.  (a) 3b's join -> group-by under each: shard for shard
   bit-identical, the first equal to phase 3's oracle, 3 exchanges of 1
   collective each when packed, and the join's two exchanges alone
   (``shuffle.collective_launches`` 2 packed, 2 x ``buffer_count`` per
   buffer; ``shuffle.compress_ratio`` 1.5 compressed); (b) ``shuffle`` by
   ``l_orderkey`` of TPC-H SF-10 lineitem (3h's 60,000,000 rows and an
   int64 ``l_orderkey``): both flags take the dictionary encoding, the
   shards are bit-identical, Q1 on the shuffled table equals 3h's
   oracle; (c) ``task_shuffle`` of two 2^24-row tables split into four
   logical tables on four workers: each output on its worker holding its
   input's rows, packed equal to per buffer; (d) ``broadcast_gather`` of
   3l (f)'s table, packed equal to per buffer in one all-gather.  Each
   first run with the counters and metrics zeroed just before and read
   just after, then best-of-3 ms, bytes sent, collective launches, the
   compress ratio and peak device memory;
3u. 3b's tables on a context over an NCCL process group of one rank
   (``MeshConfig(num_processes=1)``) holding SHARDS shards on the card:
   ``distributed_join_groupby`` through the group's collectives (a count
   all-gather and one ``all_to_all_single`` per buffer, self included),
   counters zeroed just before and read just after (the hash kernel at
   least 3 x SHARDS times, both scans), join and group counts and
   SUM/MEAN against 3b's oracle on the card, every shard equal to 3b's bit
   for bit; best-of-3 ms and rows/s, peak device memory, the phase's own
   seconds; it ends by leaving the group (``Finalize``);
3i. the main path past the card's memory: ``pipeline.make_data(OOC_ROWS)``
   (2^29 rows per side, 2^30 in all) through ``exec.chunked_join_groupby``
   in 16 key-domain passes (``pipeline.out_of_core_join_groupby``), one
   sweep: steady rate ``2*rows / run_seconds``, cold rate ``2*rows /
   total_seconds``, the plan and run seconds, the per-pass capacities,
   peak device memory over the memory allocated at the phase's start, the
   host's MemTotal / MemAvailable and the process's peak RSS; both scan
   kernels must launch in every pass (counters zeroed just before the
   sweep), and the result must equal phase 3's numpy ``bincount`` oracle
   (keys and group count exact, SUM and MEAN within rtol 1e-5 of
   float64);
3j. OOM refinement on the card with no injected fault: ``bench.py`` data
   at 2^25 rows per side (cut from phase 3's 2^26 for the script's time)
   through the engine at 2 and at 4 passes uncapped (each run's peak
   reserved memory recorded), then at 2 passes with the caching allocator
   capped between the two peaks: it must split at least once and equal
   the uncapped run (keys and group count exact, sums and means rtol
   1e-5); the cap is lifted even when the phase fails;
3m. ``chunked_groupby`` of the first 2^27 rows of 3i's left table (read
   from 3i's data) by ``k`` with SUM, MEAN and COUNT of the value, in 16
   passes (``pipeline.out_of_core_groupby``), against their numpy
   ``bincount``s with and without weights: groups and counts exact, float
   sums and means within rtol 1e-5 of float64; both scan kernels must
   launch in every pass;
3n. ``chunked_unique`` of the first 2^27 keys of that table against the
   nonzero count of their ``bincount`` (the distinct keys as a set);
3o. ``chunked_sort`` of its first 2^27 rows by ``k`` in 16 passes: keys
   never decrease, per-key counts equal the ``bincount``, per-key float64
   value sums match it (rtol 1e-5), with no host sort;
3p. ``chunked_repartition`` of 3i's two sides as one 2^30-row ``{k, v}``
   frame into 4 hash targets in 16 passes of 2^26 rows: counts sum to the
   rows, every target's keys re-hash to it under the card's
   ``hash_partition`` (in chunks), the bincount of the output keys equals
   the input's; the hash kernel launches at least once per pass;
3q. ``chunked_distributed_join_groupby`` of 2^26 rows per side over 4
   in-process shards on the one card, in 8 passes, against phase 3's
   numpy oracle; the hash kernel must launch in every pass (4 shards on
   one card, not a multi-card number);
3r. the one-shot fallback under a real allocator OOM: on 2^26-row tables
   on the card, the uncapped one-shot ``Table.join`` and a 4-pass
   ``chunked_join`` give two peaks of reserved memory; capped between
   them, ``Table.join`` must fall back (a ``table.oneshot_fallback``
   instant) and give the uncapped rows; the same for the hash
   ``Table.groupby`` against a 4-pass ``chunked_groupby``; the cap is
   lifted even when the phase fails;
3s. the front door at TPC-H SF-1 (BASELINE config 2's scale), in a
   temporary directory on an emptied card: lineitem (6,000,000 rows of
   Q1's columns and an ``l_orderkey``) and orders (1,500,000 rows) built
   with ``Table.from_numpy`` on 4 shards; (a) ``to_csv`` per shard and to
   one file, the orders file and the first lineitem file read back by
   pyarrow as an independent check (floats exactly, ``%.17g``); (b)
   ``Table.from_csv`` of the 4 files and of the one file onto 4 shards,
   every shard equal on the card to the rows written from it; (c) Q1
   through ``DataFrame`` (filter, derived columns, group-by,
   ``to_pandas``) against the numpy oracle of 3h; (d) the distributed
   orders x lineitem ``DataFrame.merge``: 6,000,000 rows and the sum of
   ``o_orderdate`` equal to numpy's; (e) ``to_parquet`` per shard of the
   Q1-filtered table and ``from_parquet`` of the files, shard for shard
   equal; (f) ``set_index`` / ``loc`` of 1,000 seeded keys / ``loc[lo:hi]``
   / ``iloc[a:b]`` on a one-shard orders table against numpy.  The native
   reader and writer must serve every CSV (``io.reader_counts``), the scan
   kernels must launch in (c) and the hash kernel in (d); each step prints
   its seconds, launches, peak device memory and reader counts, (a) and
   (b) their MB/s and rows/s;
3v. the out-of-core engine and ``DataFrame`` through a process group: a
   context over an NCCL group of one rank holding SHARDS shards (NCCL
   refuses two ranks on one card) runs
   ``pipeline.out_of_core_distributed_join_groupby`` on 2^24 rows per side
   of ``bench.py`` data in 8 passes (a quarter of 3q's rows, for the
   time), counters zeroed just before and read just after (all three
   kernels must launch); its frames must equal the in-process mesh
   engine's on the same data bit for bit, and the numpy oracle; then a
   ``DataFrame`` merge -> group-by through the group against the oracle;
   seconds, ``plan_seconds``, launches and the phase's wall time;
3w. TPC-H Q10 and Q5 through the query planner
   (``pipeline.tpch_q10_plan``, ``tpch_q5_plan``) at SF-1 (cut from
   BASELINE config 4's SF-100 for the time) on SHARDS shards of the
   in-process mesh, the tables drawn by the port's ``tpch_data``; each
   planned and eager (``CYLON_TPU_PLAN=0``): the first run with the
   counters and metrics zeroed around it (all three kernels must launch,
   at least one shuffle elided when planned), best-of-3 ms, exchanges and
   bytes sent, peak device memory; planned equal to eager bit for bit,
   both equal to a pandas float64 oracle (revenue within rtol 1e-5);
3x. the durable run journal, on 3v's data cut to 2^23 rows per side
   through the single-card engine
   (``exec.chunked_join_groupby_tables``, SUM and MEAN, 8 passes) with a
   journal root under a temporary directory removed at the end: (a) the
   run unjournaled, then journaled into an empty root: bit for bit equal,
   equal to the numpy oracle, the same launches; the overhead, spill
   bytes and ``durable.*`` counters; (b) a child process on the card
   (``chip_smoke.py --durable-worker ROOT OUT``) killed by
   ``CYLON_TPU_FAULT_PLAN=journal_commit@5=killhard`` (rc 137), then a
   fresh child resuming: 4 passes skipped, 4 run, the launches of 4 parts
   (solved per kernel from (a) and (e)), the kernels reused from the
   build cache, the frame bit for bit (a)'s; (c) (a)'s journaled call
   again: 8 passes skipped, no kernel launched; (d) 3w's planned Q10,
   twice under a journal root: the second call counts ``plan.cache_hit``
   1, launches nothing and returns the first call's rows; (e) ``bitrot``
   of one spill of (a)'s run: the reload re-executes exactly that pass
   without a peer, and read-repairs it bit for bit from a
   ``JournalPeerServer`` on 127.0.0.1 over a second root filled by
   ``pull_run`` (no pass re-executed); ``scrub_once`` then finds the
   root clean;
3y. the serving layer on one process: a ``QueryService`` on the card's
   context with a journal root under a temporary directory (removed at
   the end) and three tenants.  (a) misses, one after another with the
   launch counters zeroed around each: 3x's ``join_groupby``
   (``chunked_join_groupby_tables``, 2^23 rows per side, SUM and MEAN, 8
   passes), ``groupby`` (SUM, MEAN, COUNT of 3x's left side by ``k``),
   ``sort`` (that side by ``k``), ``plan`` (3w's Q10 on its 4-shard mesh)
   and ``refresh`` of (d)'s stream query at watermark 4: each frame bit
   for bit the same call made without the service, and its oracle; each
   request's queue-wait and run seconds and launches; (b) the same five
   again: each a ``serve.cache_hit`` with no launch, bit for bit (a)'s;
   (c) overload under ``queue_cap=8``, ``tenant_share=0.5``, unjournaled:
   while a ``join_groupby`` runs one tenant floods 12 small sorts (at
   least one shed ``ResourceExhausted`` with ``retry_after_s > 0``), the
   other tenants are admitted and exact, one queued sort is cancelled,
   ``FaultSchedule().at("serve.admit", "tenant_flood")`` sheds exactly
   one submission, a one-byte device-memory budget sheds at admission,
   and ``drain()`` sheds the queue with ``Unavailable`` while the
   in-flight group-by finishes exactly; (d) a ``StreamTable`` of 3w's
   SF-1 lineitem (its four numeric Q10 columns, 6,001,215 rows) in 6
   micro-batches: ``GroupByQuery`` by ``l_orderkey`` (SUM of
   ``l_extendedprice``, MEAN of ``l_quantity``, COUNT) refreshed at 4 and
   6, the second folding only batches 5-6 (its launches against the
   first's), each bit for bit ``recompute_cold()`` and a pandas float64
   oracle within rtol 1e-5; a ``JoinQuery`` of the batches against orders
   probing only the delta, against numpy; (e) ``openmetrics.start_server
   (0)`` on 127.0.0.1: one scrape parses and carries the per-tenant
   latency histograms with their ``le`` buckets and
   ``serve_cache_hit`` 5.  It prints the phase's seconds, peak device
   memory and the card's name and power limit.
3z. the fleet on one card: five children of this script, each its own
   process with its own CUDA context on the card, started together after
   the kernels were built.  (a) the elastic gang: an
   ``elastic.Coordinator(3)`` here and three ``--elastic-worker``
   children, each an ``ElasticConfig`` context of one shard on the card
   running ``elastic_run`` over 3x's data and call partitioned by
   splitmix64 (``mode="hash"``, 8 passes) into a shared journal; rank 1
   dies at its 2nd pass boundary (``elastic.pass.r1@2=rank_kill``, rc
   137).  The coordinator's ledger must record a ``heartbeat timeout``
   and an epoch of at least 1, each survivor's frame must equal the
   unjournaled one-process run made here bit for bit, and each
   survivor's assembly must load all 8 passes and launch nothing; it
   prints each rank's parts per epoch, launches and seconds, the
   seconds from the kill to the epoch bump and each agent's longest
   heartbeat gap.  (b) the query router: a ``QueryRouter(2)`` here and
   two ``--replica-worker`` children (a ``QueryService`` on the card
   behind a ``ReplicaServer``, attached to an ``elastic.Agent``) sharing
   one journal, each with an idempotent ``kjoin`` op behind
   ``router.pass.r<rank>``: one ``join_groupby`` of 2^21 rows per side
   through ``RouterClient.route`` (a miss), the same again (cache
   affinity: the same replica, a journal hit with no launch), the same
   from a second tenant pinned to the other replica (cache affinity off:
   a hit of the shared journal there, no launch), then a flood of 12
   ``kjoin`` of 2^18 rows per side from 3 tenants while replica 1 dies
   at its 3rd (``router.pass.r1@3=rank_kill``): every answer bit for bit
   the direct call, every refusal a classified retryable ``Unavailable``
   or ``ResourceExhausted``, at least one re-route, replica 1 fenced,
   and ``tools/fleet_status.py --json --replicas`` rc 0 listing both
   replicas' breakers.  Per request it prints the route seconds, the
   replica, its run seconds and launches (from the children's records),
   and the wire bytes with the client's encode and decode seconds;
3aa. the BASELINE example drivers (``cylon_tpu_torch/examples``) through
   their own ``run`` functions on the card, each with its golden check
   on, the launch counters zeroed just before each and read just after:
   ``join_csv`` (2^19 rows per CSV, the join's row count against a numpy
   ``bincount`` oracle), TPC-H Q1, Q3, Q6 and eager Q5 (SF-0.1 each), the
   out-of-core Q5 chain (SF-1 in 4 passes, on 3w's tables and pandas
   oracle), ``shuffle_bench.run`` (2^24 rows on SHARDS shards, per-shard
   Parquet into a temporary directory), ``shuffle_bench.run_ooc`` (2^24
   rows into 8 targets in 2 passes),
   ``scaling`` (weak, 2^22 rows per shard, worlds 1, 2 and 4 on the one
   card: the rung's overhead, not scaling across cards) and
   ``etl_to_torch`` (2M events, 5,000 users, 50 Adam steps, a finite
   loss); it prints each driver's record, wall seconds, launches and peak
   device memory, and the phase must launch every kernel;
3ab. the port's cylint (``cylon_tpu_torch/analysis``) on the card, the
   launch counters zeroed just before: (a) the seven collective-budget
   entries at the canonical grid (world 4, shard capacity 64, six
   columns) on SHARDS shards of the card, whose mesh collective counts
   must equal the committed goldens (written on the CPU) exactly, each
   entry's hand-kernel launches printed (the goldens' process-group
   counts need two processes, which one card cannot group over NCCL:
   the CPU tests and the CLI hold those); (b) the serve/elastic/router smoke with
   its ``QueryService`` on the card under the lock recorder: every
   observed lock-order edge must be in the committed golden and in the
   static lock graph; (c) the AST and concurrency scan of the package: no
   finding;
3ac. (run after 3u, before phase 4, on phase 3's and 3b's tables, the
   launch counters zeroed just before) the local kernels' one
   realization, each run's outputs bit for bit a first run's and its
   best-of-3 ms printed: (a) phase 3's path and 3b's; (b)
   ``keys.lexsort_indices`` alone at 2^27 rows (the path's combined
   sort); (c) the 64-bit audit (``analysis/dtype_audit.py``) of one
   narrow run of phase 3: each 64-bit site, its bytes and its share; (d)
   the device-memory watermark (``obs.metrics.record_hbm_watermark``) at
   least the live tables' bytes;
   Each of 3m-3r zeroes the launch counters just before its call, reads
   them just after, and prints its stats, peak device memory, host
   memory and call time; their checks run on the card (``_card``), since
   numpy takes seconds per pass over 2^29 rows on the card's host;
4. each kernel's time at the main path's shapes (CUDA events), its bound
   (bytes over 3.35 TB/s), its plain version's time and, where one
   PyTorch call computes the same function, that call's time; ``scan_1d``
   in all three of ``run_extents``' variants (sum, max, reversed min) at
   both the single-chip and the per-shard shape.

It prints the script's wall time, a ``{"kernels": [...]}`` line, the
``nvidia-smi`` name and power limit line, and, last, ``{"ok": true,
"device": {...}}``.  ``--durable-worker ROOT OUT`` is phase 3x's
child, ``--elastic-worker RANK WORLD ADDR OUT`` and ``--replica-worker
RANK WORLD ADDR OUT`` are 3z's; they print no result; ``--serve-profile OUT`` (``serve_profile``)
times 3y's served ``join_groupby`` miss against the same call made
directly, with a host profile of each, and prints no result.  Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.  ``--out`` also writes every number to a JSON file; ``--profile``
adds a device-time breakdown by kernel of one run of each main path (the
hash join's included), of the set ops, of the distributed sorts, of the
string paths, of Q1, of a second out-of-core sweep (whose device busy
share of its wall time is the engine's idle measure) and of a second run
of 3m, 3o, 3p and 3q, of one 3v engine run and of each 3w query
(planned), and a stage breakdown of one distributed run.  Phases 3i-3aa
run after phase 4, once the earlier phases' tensors are freed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
ROWS = 1 << 26  # main-path rows per side: the TPU ladder's top size
OOC_ROWS = 1 << 29  # out-of-core rows per side: bench.py's 1B-row ladder
OOC_PASSES = 16
SHARDS = 4  # distributed path: shards of the in-process mesh, one card
SCAN_SOURCE = "cylon_tpu_torch/cuda/scan.cu"
HASH_SOURCE = "cylon_tpu_torch/cuda/murmur3.cu"
KERNELS = {
    # name -> (TPU kernel it replaces, bytes each element must move)
    "scan_1d": ("cylon_tpu/ops/pallas_scan.py:222", 8),
    "segmented_scan": ("cylon_tpu/ops/pallas_scan.py:150", 9),
    # int32 key + bool validity in, uint32 hash + int32 target out
    "hash_partition": ("cylon_tpu/ops/pallas_kernels.py:113", 13),
}
F32_SUM_RTOL = 1e-5  # float32 sums: tree-order rounding, the reference's rtol
F32_SUM_ATOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
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


# -- phase 1 ------------------------------------------------------------------

def phase_build(report: dict) -> None:
    import torch

    from cylon_tpu_torch import native
    from cylon_tpu_torch.cuda import build
    from cylon_tpu_torch.native import build as native_build

    report["smi"] = smi_line()
    log(f"[1] card: {report['smi']}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    sources = sorted(p for p in os.listdir(os.path.dirname(build.__file__))
                     if p.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources) + 1) as pool:
        host_lib = pool.submit(native_build.build)
        list(pool.map(build.build, sources))
        host_lib = host_lib.result()
    report["build_s"] = time.perf_counter() - t0
    if not native.available():
        raise AssertionError(f"native library: {native.load_error()}")
    log(f"[1] built {sources} and the host library {host_lib.name} (g++) "
        f"in {report['build_s']:.1f} s")
    for src in sources:
        regs = [int(w) for line in build.BUILD_INFO[src][1].splitlines()
                if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        log(f"[1]   {src}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers per thread")


# -- phase 2 ------------------------------------------------------------------

def _f32_oracle(x, reset):
    """float64 segmented inclusive sum."""
    import torch

    cs = torch.cumsum(x.double(), 0)
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    start = torch.cummax(torch.where(reset, idx, torch.zeros_like(idx)),
                         0).values
    before = torch.where(start > 0, cs[(start - 1).clamp(min=0)],
                         torch.zeros_like(cs))
    return cs - before


def _f32_oracle_1d(x, reverse):
    """float64 inclusive sum, right to left if ``reverse``."""
    import torch

    xd = x.double().flip(0) if reverse else x.double()
    cs = torch.cumsum(xd, 0)
    return cs.flip(0) if reverse else cs


def _compare(name, got, want, exact, oracle=None):
    """Max abs error of ``got`` against ``want`` (the plain version);
    exact cases must match bit for bit, float32 sums must lie within the
    stated tolerance of the float64 oracle."""
    import torch

    if exact:
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name}: {bad} elements differ from plain")
        return 0.0
    err = float((got.double() - want.double()).abs().max())
    ref = oracle if oracle is not None else want.double()
    tol = F32_SUM_RTOL * ref.abs() + F32_SUM_ATOL
    over = (got.double() - ref).abs() > tol
    if bool(over.any()):
        raise AssertionError(f"{name}: {int(over.sum())} elements outside "
                             f"rtol={F32_SUM_RTOL} atol={F32_SUM_ATOL}")
    return err


def phase_kernels(report: dict) -> None:
    import torch

    from cylon_tpu_torch.ops import scan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {"scan_1d": 0.0, "segmented_scan": 0.0, "hash_partition": 0.0}
    passed = {"scan_1d": 0, "segmented_scan": 0, "hash_partition": 0}
    checks = []

    def ints(n, hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def plain_case(n, x, op, reverse, label=""):
        got = scan.scan_1d(x, op, reverse)
        want = scan.scan_1d_plain(x, op, reverse)
        f32sum = x.dtype == torch.float32 and op == "sum"
        oracle = _f32_oracle_1d(x, reverse) if f32sum else None
        e = _compare(f"scan_1d {op} rev={reverse} n={n}{label} {x.dtype}",
                     got, want, exact=not f32sum, oracle=oracle)
        errs["scan_1d"] = max(errs["scan_1d"], e)
        passed["scan_1d"] += 1
        checks.append(f"scan_1d {x.dtype} {op} rev={reverse} n={n}{label}")

    def seg_case(n, x, reset, op):
        got = scan.segmented_scan(x, reset, op)
        want = scan.segmented_scan_plain(x, reset, op)
        f32sum = x.dtype == torch.float32 and op == "sum"
        oracle = _f32_oracle(x, reset) if f32sum else None
        e = _compare(f"segmented_scan {op} n={n} {x.dtype}", got, want,
                     exact=not f32sum, oracle=oracle)
        errs["segmented_scan"] = max(errs["segmented_scan"], e)
        passed["segmented_scan"] += 1
        checks.append(f"segmented_scan {x.dtype} {op} n={n} "
                      f"resets={int(reset.sum())}")

    n = 1 << 27
    member = ints(n, 2)
    wide = ints(n, 1 << 30) - (1 << 29)
    for op in ("sum", "max", "min"):
        for rev in (False, True):
            plain_case(n, member if op == "sum" else wide, op, rev)
    del member, wide

    n = 1 << 26
    xf = torch.rand(n, generator=gen, device=dev)
    xi = ints(n, 1000)
    r1 = torch.rand(n, generator=gen, device=dev) < 0.01
    r1[0] = True
    for op in ("sum", "min", "max"):
        seg_case(n, xf, r1, op)
    seg_case(n, xi, r1, "sum")
    for reset in (torch.ones(n, dtype=torch.bool, device=dev),
                  torch.zeros(n, dtype=torch.bool, device=dev)):
        seg_case(n, xf, reset, "sum")
        seg_case(n, xi, reset, "max")
    del xf, xi, r1

    for n in (1, 1023, 4097):
        xi = ints(n, 1 << 20) - (1 << 19)
        xf = torch.rand(n, generator=gen, device=dev)
        r = torch.rand(n, generator=gen, device=dev) < 0.05
        for op in ("sum", "min", "max"):
            for rev in (False, True):
                plain_case(n, xi, op, rev)
            plain_case(n, xf, op, False)
            seg_case(n, xf, r, op)
            seg_case(n, xi, r, op)
        # uint32 through its bit pattern: sums wrap like int32, and
        # unsigned order is the signed order with the top bit flipped
        xu = xi.view(torch.uint32)
        got = scan.segmented_scan(xu, r, "sum").view(torch.int32)
        _compare(f"segmented_scan uint32 sum n={n}", got,
                 scan.segmented_scan(xi, r, "sum"), exact=True)
        flip = torch.tensor(-(1 << 31), dtype=torch.int32, device=dev)
        for op in ("min", "max"):
            got = scan.scan_1d(xu, op).view(torch.int32) ^ flip
            _compare(f"scan_1d uint32 {op} n={n}", got,
                     scan.scan_1d(xi ^ flip, op), exact=True)
        passed["segmented_scan"] += 1
        passed["scan_1d"] += 2
        checks.append(f"uint32 sum/min/max n={n}")
    _lookback_checks(dev, gen, plain_case, passed, checks)
    _hash_checks(dev, passed, checks)
    torch.cuda.synchronize()
    report["kernel_checks"] = checks
    report["checks_passed"] = passed
    report["max_abs_err"] = errs
    log(f"[2] {len(checks)} kernel checks passed; max abs err {errs}")


def _lookback_checks(dev, gen, plain_case, passed, checks) -> None:
    """scan_1d's look-back kernel at its edges, exact against the plain
    version: the tile size -1, +0, +1 and +2, n % 4 in 0-3 over 40 tiles
    (past one 32-tile look-back window) and at 2^27 + 3, both directions
    (vector and element-wise paths), views 4, 8 and 12 bytes past a 16-byte
    boundary; then 20 calls on one input, all equal."""
    import torch

    from cylon_tpu_torch.ops import scan

    def ints(n, hi, off=0):
        return (torch.randint(0, hi, (n + off,), generator=gen, device=dev,
                              dtype=torch.int32) - hi // 2)[off:]

    tile = scan.SCAN_1D_TILE
    sizes = [(tile + d, 0) for d in (-1, 0, 1, 2)]
    sizes += [(40 * tile + r, 0) for r in range(4)]
    sizes += [(40 * tile + 1, off) for off in (1, 2, 3)]
    for n, off in sizes:
        x = ints(n, 1 << 20, off)
        for op in ("sum", "min", "max"):
            for rev in (False, True):
                plain_case(n, x, op, rev, f" offset={off}" if off else "")
    n = (1 << 27) + 3
    x = ints(n, 1 << 31)  # sums wrap
    for op in ("sum", "min", "max"):
        for rev in (False, True):
            plain_case(n, x, op, rev)
    del x
    member = ints(1 << 27, 2) + 1
    first = scan.scan_1d(member, "sum")
    for _ in range(19):
        if not torch.equal(scan.scan_1d(member, "sum"), first):
            raise AssertionError("scan_1d: repeated int32 sums differ")
    passed["scan_1d"] += 1
    checks.append(f"scan_1d int32 sum n={1 << 27}: 20 calls equal")


def _hash_checks(dev, passed, checks) -> None:
    """The murmur3 hash-partition kernel against its plain version on the
    card, bit for bit: every key dtype, nulls, 1- and 2-column keys, mask
    and modulo worlds, ragged sizes, and the main path's 2^26 int32 keys."""
    import numpy as np
    import torch

    from cylon_tpu_torch import column
    from cylon_tpu_torch.ops import hash_kernels

    rng = np.random.default_rng(13)

    def case(cols, world, label):
        h, t = hash_kernels.hash_partition(cols, world)
        ph, pt = hash_kernels.hash_partition_plain(cols, world)
        if not (torch.equal(h.view(torch.int32), ph.view(torch.int32))
                and torch.equal(t, pt)):
            bad = int((h.view(torch.int32) != ph.view(torch.int32)).sum())
            raise AssertionError(f"hash_partition {label} world={world}: "
                                 f"{bad} hashes differ from plain")
        passed["hash_partition"] += 1
        checks.append(f"hash_partition {label} world={world}")

    def col(dtype, n):
        if dtype == np.bool_:
            v = rng.random(n) > 0.5
        else:
            v = rng.integers(-(1 << 62), 1 << 62, n).astype(dtype)
        return column.from_numpy(v, validity=rng.random(n) > 0.1,
                                 capacity=n + 3, device=dev)

    dtypes = (np.int8, np.int16, np.int32, np.int64, np.uint32, np.float32,
              np.float64, np.bool_)
    for n in (1, 255, 257, 4097, (1 << 20) + 3):
        cols = {np.dtype(d).name: col(d, n) for d in dtypes}
        for name, c in cols.items():
            for world in (4, 6):
                case([c], world, f"{name} n={n}")
        for world in (4, 6):
            case([cols["int32"], cols["float64"]], world,
                 f"int32+float64 n={n}")
    _float_key_checks(dev, case, passed, checks)
    n = ROWS
    keys = column.Column(
        torch.randint(0, n, (n,), generator=torch.Generator(device=dev)
                      .manual_seed(17), device=dev, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool, device=dev), None,
        column.dtypes.int32)
    for world in (4, 6):
        case([keys], world, f"int32 keys n={n}")


def _float_key_checks(dev, case, passed, checks) -> None:
    """Float keys fold in the kernel as in the plain version: -0.0 hashes
    as +0.0, every NaN payload (kept by an explicit validity) as one NaN,
    for float16, bfloat16, float32 and float64."""
    import numpy as np
    import torch

    from cylon_tpu_torch import column
    from cylon_tpu_torch.ops import hash_kernels

    nan32 = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FC0BEEF],
                     np.uint32).view(np.float32)
    base = np.concatenate([[0.0, -0.0, np.inf, -np.inf, 1.5, -1.5],
                           nan32.astype(np.float64)])
    rng = np.random.default_rng(19)
    vals = np.concatenate([base, rng.standard_normal(4091)])
    for dt in (torch.float16, torch.bfloat16, torch.float32, torch.float64):
        data = torch.from_numpy(vals).to(dt)
        if dt == torch.float32:  # the exact NaN payloads above
            data[6:10] = torch.from_numpy(nan32)
        data = data.to(dev)
        c = column.Column(data, torch.ones(len(vals), dtype=torch.bool,
                                           device=dev), None,
                          column.dtypes.float_)
        for world in (4, 6):
            case([c], world, f"{dt} +-0 and NaN payloads")
        h, _ = hash_kernels.hash_partition([c], 4)
        h = h.view(torch.int32).cpu()
        if h[0] != h[1] or len(set(h[6:10].tolist())) != 1:
            raise AssertionError(f"hash_partition {dt}: +0.0/-0.0 or NaN "
                                 f"payloads hash apart: {h[:10].tolist()}")
        passed["hash_partition"] += 1
        checks.append(f"hash_partition {dt}: -0.0 as +0.0, one NaN")


# -- phase 3 ------------------------------------------------------------------

def _oracle(data, rows: int) -> dict:
    """float64 oracle of the join -> SUM/MEAN group-by on
    ``pipeline.make_data`` tables: join count, group keys (ascending),
    float64 SUM(lv) and MEAN(rv) per group.  Per-key counts and sums by
    torch's own ``index_add_`` on the card (none of the port's code): a
    numpy ``bincount`` holds the GIL for a minute at 2^29 rows.  The
    inputs go up in slices, so the card holds the four rows-long
    accumulators and one slice."""
    import torch

    dev = torch.device("cuda")
    lk, lv, rk, rv = data
    cl = torch.zeros(rows, dtype=torch.int64, device=dev)
    cr = torch.zeros_like(cl)
    sl = torch.zeros(rows, dtype=torch.float64, device=dev)
    sr = torch.zeros_like(sl)
    step = 1 << 26
    for keys, vals, cnt, acc in ((lk, lv, cl, sl), (rk, rv, cr, sr)):
        for i in range(0, len(keys), step):
            k = torch.from_numpy(keys[i:i + step]).to(dev).long()
            cnt.index_add_(0, k, torch.ones_like(k))
            acc.index_add_(0, k, torch.from_numpy(
                vals[i:i + step]).to(dev).double())
            del k
    keys = torch.nonzero((cl > 0) & (cr > 0)).squeeze(1)
    cr_k = cr[keys]
    out = {"join": int((cl * cr).sum()), "groups": int(keys.numel()),
           "keys": keys.int().cpu().numpy(),
           "sum": (sl[keys] * cr_k).cpu().numpy(),
           "mean": (sr[keys] / cr_k).cpu().numpy()}
    del cl, cr, sl, sr, keys, cr_k
    torch.cuda.empty_cache()
    return out


def _check_groups(oracle: dict, keys, sums, means, label: str):
    """Group keys exact, SUM and MEAN within rtol of the float64 oracle;
    returns their max abs errors."""
    import numpy as np

    if not np.array_equal(keys, oracle["keys"]):
        raise AssertionError(f"{label}: group keys differ from the oracle")
    errs = []
    for name, got in (("sum", sums), ("mean", means)):
        want = oracle[name]
        err = np.abs(np.asarray(got, np.float64) - want)
        bad = np.count_nonzero(~(err <= F32_SUM_RTOL * np.abs(want)))
        if bad:
            raise AssertionError(f"{label}: {bad} {name}s outside rtol "
                                 f"{F32_SUM_RTOL} of the oracle")
        errs.append(float(err.max(initial=0.0)))
    return tuple(errs)


def _launch_counts() -> dict:
    from cylon_tpu_torch.ops import hash_kernels, scan

    return {**scan.LAUNCHES, **hash_kernels.LAUNCHES}


def _reset_launches() -> None:
    from cylon_tpu_torch.ops import hash_kernels, scan

    scan.reset_launches()
    hash_kernels.reset_launches()


def _best_of_5(fn, rows: int):
    """(times, rows/s of the best, peak device bytes) of five synchronised
    runs of ``fn``; the peak is over those runs, resident inputs included."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, 2 * rows / min(times), torch.cuda.max_memory_allocated()


def phase_main_path(report: dict, rows: int) -> dict:
    import torch

    from cylon_tpu_torch import pipeline

    data = pipeline.make_data(rows, pipeline.SEED)
    tables = pipeline.tables(*data)  # default device: the card

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    m = pipeline.join_count(*tables)
    out_cap = pipeline.cap_round(m)
    gcols, g, jm = pipeline.join_groupby(*tables, out_cap)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    log(f"[3] rows/side={rows} join_count={m} out_cap={out_cap} "
        f"first run {first_s:.3f} s launches={launches}")
    if launches["scan_1d"] < 3 or launches["segmented_scan"] < 2:
        raise AssertionError(f"main path did not go through the scan "
                             f"kernels: {launches}")

    oracle = _oracle(data, rows)
    g_n, jm_n = int(g), int(jm)
    if (m, jm_n, g_n) != (oracle["join"], oracle["join"], oracle["groups"]):
        raise AssertionError(f"counts: join {m}/{jm_n} group {g_n}, oracle "
                             f"join {oracle['join']} group "
                             f"{oracle['groups']}")
    valid = [c.validity.cpu().numpy() for c in gcols]
    for v in valid:
        if not (v[:g_n].all() and not v[g_n:].any()):
            raise AssertionError("group validity is not the live prefix")
    sum_err, mean_err = _check_groups(
        oracle, gcols[0].data[:g_n].cpu().numpy(),
        gcols[1].data[:g_n].cpu().numpy(), gcols[2].data[:g_n].cpu().numpy(),
        "single chip")
    log(f"[3] oracle: join {oracle['join']} groups {oracle['groups']} exact; "
        f"SUM max abs err {sum_err:.3g}, MEAN max abs err {mean_err:.3g} "
        f"(rtol {F32_SUM_RTOL})")
    del gcols, g, jm

    times, rate, peak = _best_of_5(
        lambda: pipeline.join_groupby(*tables, out_cap), rows)
    report["main_path"] = {
        "rows_per_side": rows, "join_count": m, "groups": oracle["groups"],
        "out_cap": out_cap, "launches": launches, "first_run_s": first_s,
        "times_s": times, "rows_per_s": rate,
        "peak_device_bytes": peak, "sum_max_abs_err": sum_err,
        "mean_max_abs_err": mean_err}
    log(f"[3] best-of-5 {min(times) * 1e3:.2f} ms -> {rate:.6g} rows/s; "
        f"times {[round(t * 1e3, 2) for t in times]} ms; peak device "
        f"memory {peak / 2**30:.2f} GiB")
    return {"tables": tables, "out_cap": out_cap, "launches": launches,
            "data": data, "oracle": oracle}


def phase_distributed(report: dict, main: dict, rows: int) -> dict:
    """The distributed path, 2^26 rows per side in SHARDS shards on the
    one card."""
    import torch

    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline

    ctx = CylonContext.InitDistributed(MeshConfig(world_size=SHARDS))
    left, right = pipeline.distributed_tables(ctx, *main["data"])
    oracle = main["oracle"]

    ctx.Barrier()
    _reset_launches()
    t0 = time.perf_counter()
    groups, joined = pipeline.distributed_join_groupby(left, right)
    ctx.Barrier()
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    log(f"[3b] {SHARDS} shards on {sorted({str(d) for d in ctx.devices})}: "
        f"first run {first_s:.3f} s launches={launches}")
    if launches["hash_partition"] < 3 * SHARDS or launches["scan_1d"] < 1 \
            or launches["segmented_scan"] < 1:
        raise AssertionError(f"distributed path did not go through the "
                             f"kernels: {launches}")

    jm, g = joined.row_count, groups.row_count
    if (jm, g) != (oracle["join"], oracle["groups"]):
        raise AssertionError(f"distributed counts: join {jm} group {g}, "
                             f"oracle join {oracle['join']} group "
                             f"{oracle['groups']}")
    out = groups.to_numpy()
    for name, v in out.items():
        if v.dtype == object:
            raise AssertionError(f"distributed output {name} has nulls")
    order = out["l_k"].argsort()
    sum_err, mean_err = _check_groups(oracle, out["l_k"][order],
                                      out["sum_lv"][order],
                                      out["mean_rv"][order], "distributed")
    log(f"[3b] oracle: join {jm} groups {g} exact; SUM max abs err "
        f"{sum_err:.3g}, MEAN max abs err {mean_err:.3g} (rtol "
        f"{F32_SUM_RTOL}); join rows per shard "
        f"{joined.row_counts.tolist()}, capacity {joined.shard_capacity}")
    shard_caps = {"join": joined.shard_capacity,
                  "groups": groups.shard_capacity}
    del groups, joined, out

    resident = torch.cuda.memory_allocated()
    times, rate, peak = _best_of_5(
        lambda: pipeline.distributed_join_groupby(left, right), rows)
    report["distributed_path"] = {
        "shards": SHARDS, "devices": [str(d) for d in ctx.devices],
        "rows_per_side": rows, "join_count": jm, "groups": g,
        "launches": launches, "first_run_s": first_s, "times_s": times,
        "rows_per_s": rate, "peak_device_bytes": peak,
        "resident_bytes_before": resident, "shard_capacities": shard_caps,
        "sum_max_abs_err": sum_err, "mean_max_abs_err": mean_err}
    log(f"[3b] best-of-5 {min(times) * 1e3:.2f} ms -> {rate:.6g} rows/s "
        f"({SHARDS} shards on one card); times "
        f"{[round(t * 1e3, 2) for t in times]} ms; peak device memory "
        f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident "
        f"before the runs)")
    return {"ctx": ctx, "left": left, "right": right, "launches": launches}


def phase_hash_partition(report: dict, dist: dict, rows: int) -> None:
    """HashPartition of the left table into 3 partitions (the modulo
    branch): sizes sum to the rows, and each partition's keys re-hash to
    it under the plain version."""
    import torch

    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.ops import hash_kernels

    left, parts_n = dist["left"], 3
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    parts = left.hash_partition("k", parts_n)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    sizes = {p: t.row_count for p, t in parts.items()}
    if sum(sizes.values()) != rows:
        raise AssertionError(f"partition sizes {sizes} do not sum to {rows}")
    if launches["hash_partition"] != left.num_shards:
        raise AssertionError(f"HashPartition launches {launches}")
    per_shard = [0] * left.num_shards
    for p, t in parts.items():
        for s, (cols, n) in enumerate(zip(t.shards, t.row_counts)):
            n = int(n)
            per_shard[s] += n
            k = cols[0]
            live = Column(k.data[:n], k.validity[:n], None, k.dtype)
            _, tgt = hash_kernels.hash_partition_plain([live], parts_n)
            if not bool((tgt == p).all()):
                raise AssertionError(f"partition {p} shard {s} holds rows "
                                     "of another partition")
    if per_shard != left.row_counts.tolist():
        raise AssertionError(f"rows per shard {per_shard} != "
                             f"{left.row_counts.tolist()}")
    report["hash_partition"] = {"partitions": parts_n, "sizes": sizes,
                                "launches": launches, "first_run_s": first_s,
                                "capacities": {p: t.shard_capacity
                                               for p, t in parts.items()}}
    log(f"[3c] HashPartition of {rows} rows into {parts_n}: sizes {sizes}, "
        f"every key re-hashes to its partition; {first_s * 1e3:.2f} ms "
        f"first run; launches={launches}")


# -- phases 3d and 3e ---------------------------------------------------------

def _time_op(fn, input_rows: int, runs: int = 5) -> dict:
    """Best-of-``runs`` synchronised wall time of ``fn``, input rows per
    second of the best, and peak device memory over the runs (resident
    inputs included)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"best_ms": min(times) * 1e3, "times_ms": [t * 1e3 for t in times],
            "rows_per_s": input_rows / min(times),
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def _first_run(fn):
    """(result, seconds, launches) of one synchronised run of ``fn`` with
    every launch counter zeroed just before it and read just after."""
    import torch

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _launch_counts()


def _cols(t, names=None) -> dict:
    """A table's live rows on the host, every column, no nulls allowed."""
    out = t.to_numpy()
    for name, v in out.items():
        if v.dtype == object:
            raise AssertionError(f"column {name} has nulls")
    return out if names is None else {n: out[n] for n in names}


def _expect_equal(label: str, got, want) -> None:
    import numpy as np

    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{label}: {got.shape[0]} values differ from "
                             f"the oracle's {want.shape[0]}")


def _expect_zero_tail(label: str, t) -> None:
    """Every shard's rows past its count are zero and null (the set ops'
    output over its whole capacity)."""
    import torch

    for cols, n in zip(t.shards, t.counts):
        n = int(n)
        for c in cols:
            if bool(c.validity[n:].any()) or bool(
                    (c.data[n:] != 0).any()):
                raise AssertionError(f"{label}: rows past the count are "
                                     "not zero and null")
    torch.cuda.synchronize()


def _packed(k, v):
    """uint64 rows (k, v): k's bits high, v's float bits low; for
    non-negative v this order is the set ops' (k, v) order."""
    import numpy as np

    return ((k.astype(np.int64).astype(np.uint64) << np.uint64(32))
            | v.view(np.uint32).astype(np.uint64))


def _stable_order(k):
    """``np.argsort(k, kind="stable")`` of int32 keys, as one direct sort
    of (key, row) packed into a uint64: numpy's indirect sorts take
    minutes at 2^26 rows, a direct sort seconds."""
    import numpy as np

    bits = max(1, (k.shape[0] - 1).bit_length())
    packed = ((k.astype(np.int64) - int(k.min())).astype(np.uint64)
              << np.uint64(bits)) | np.arange(k.shape[0], dtype=np.uint64)
    packed.sort()
    return (packed & np.uint64((1 << bits) - 1)).astype(np.int64)


def _occurrences(k, order):
    """(first, last): the row of each key's first and last occurrence, in
    key order, from ``order = _stable_order(k)``."""
    import numpy as np

    ks = k[order]
    start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    end = np.r_[start[1:] - 1, ks.shape[0] - 1]
    return order[start], order[end]


def _desc_asc(k, v):
    """(k, v) rows sorted by k descending, then v ascending, for v >= 0:
    one direct sort of (max - k, v's float bits) packed into a uint64."""
    import numpy as np

    kmax = int(k.max())
    packed = (((kmax - k.astype(np.int64)).astype(np.uint64)
               << np.uint64(32)) | v.view(np.uint32).astype(np.uint64))
    packed.sort()
    return ((kmax - (packed >> np.uint64(32)).astype(np.int64))
            .astype(k.dtype),
            (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(v.dtype))


def _distinct(x):
    """The distinct values of ``x``, ascending, by one direct sort (numpy
    2.3's ``np.unique`` family hashes, which takes minutes at 2^27)."""
    import numpy as np

    x = np.sort(x)
    return x[np.r_[True, x[1:] != x[:-1]]]


def _rows_in_order(idx, n: int):
    """The row indices ``idx`` in ascending order, by a scatter into a
    mask rather than a sort."""
    import numpy as np

    mask = np.zeros(n, bool)
    mask[idx] = True
    return np.flatnonzero(mask)


def _local_oracle(data, rows: int) -> dict:
    """numpy answers of ``pipeline.operator_calls`` on ``make_data``.
    The keys lie in ``[0, rows)``, so key sets are ``bincount`` masks;
    the orders come from three direct sorts of packed words; no
    ``np.unique`` family call (see ``_distinct``)."""
    import numpy as np

    lk, lv, rk, rv = data
    in_l = np.bincount(lk, minlength=rows) > 0
    in_r = np.bincount(rk, minlength=rows) > 0
    order = _stable_order(lk)
    first_by_key, last_by_key = _occurrences(lk, order)
    first = _rows_in_order(first_by_key, rows)
    last = _rows_in_order(last_by_key, rows)
    dk, dv = _desc_asc(lk, lv)
    mask = lv > 0.5
    return {
        "order": order, "first_by_key": first_by_key,
        "sort": {"k": lk[order], "lv": lv[order]},
        "sort_k_desc_lv": {"k": dk, "lv": dv},
        "unique_first": {"k": lk[first], "lv": lv[first]},
        "unique_last": {"k": lk[last], "lv": lv[last]},
        "union": {"k": np.flatnonzero(in_l | in_r)},
        "intersect": {"k": np.flatnonzero(in_l & in_r)},
        "subtract": {"k": np.flatnonzero(in_l & ~in_r)},
        "union_rows": _distinct(np.concatenate([_packed(lk, lv),
                                                _packed(rk, rv)])),
        "select": {"k": lk[mask], "lv": lv[mask]},
        "filter": {"k": lk[mask], "lv": lv[mask]},
        "sum": float(lv.astype(np.float64).sum()),
        "min": int(lk.min()), "max": int(lk.max()), "count": rows,
        "groupby_pipeline": (np.flatnonzero(in_l), np.bincount(
            lk, weights=lv.astype(np.float64), minlength=rows)),
    }


def _check_local(name: str, out, want) -> float:
    """Hold one operator's result to its oracle; returns the max abs
    error of a float sum (0 for exact checks)."""
    import numpy as np

    if name in ("sum", "min", "max", "count"):
        got = float(out.double()) if name == "sum" else int(out)
        if name == "sum":
            if abs(got - want) > F32_SUM_RTOL * abs(want):
                raise AssertionError(f"sum {got} vs oracle {want}")
            return abs(got - want)
        if got != want:
            raise AssertionError(f"{name} {got} vs oracle {want}")
        return 0.0
    if name == "union_rows":
        rows = _cols(out)
        _expect_equal(name, _packed(rows["k"], rows["lv"]), want)
        _expect_zero_tail(name, out)
        return 0.0
    if name == "groupby_pipeline":
        keys, sums = want
        got = _cols(out)
        _expect_equal(f"{name} keys", got["k"], keys)
        np.testing.assert_allclose(got["sum_lv"].astype(np.float64),
                                   sums[keys], rtol=F32_SUM_RTOL)
        return float(np.abs(got["sum_lv"] - sums[keys]).max(initial=0.0))
    got = _cols(out, list(want))
    for col, v in want.items():
        _expect_equal(f"{name} {col}", got[col], v)
    if name in ("union", "intersect", "subtract"):
        _expect_zero_tail(name, out)
    return 0.0


def phase_operators(report: dict, main: dict, rows: int) -> dict:
    """Phase 3d: the relational operators on the phase-3 tables, wrapped
    as one-shard Tables on the card, each against its numpy oracle."""
    from cylon_tpu_torch import pipeline

    left, right = pipeline.local_tables(*main["tables"])
    calls = pipeline.operator_calls(left, right)
    t0 = time.perf_counter()
    oracle = _local_oracle(main["data"], rows)
    log(f"[3d] numpy oracles in {time.perf_counter() - t0:.1f} s")
    two_sided = {"union", "intersect", "subtract", "union_rows"}
    results = {}
    for name, fn in calls.items():
        out, first_s, launches = _first_run(fn)
        err = _check_local(name, out, oracle[name])
        if name in two_sided and launches["scan_1d"] < 6:
            raise AssertionError(f"{name}: {launches['scan_1d']} scan_1d "
                                 "launches, expected at least 6")
        if name == "groupby_pipeline" and launches["segmented_scan"] < 1:
            raise AssertionError(f"{name}: no segmented_scan launch")
        del out
        r = _time_op(fn, 2 * rows if name in two_sided else rows)
        r.update(first_run_s=first_s, launches=launches, max_abs_err=err)
        results[name] = r
        log(f"[3d] {name}: best-of-5 {r['best_ms']:.2f} ms -> "
            f"{r['rows_per_s']:.6g} rows/s, first run {first_s:.3f} s, "
            f"peak {r['peak_device_bytes'] / 2**30:.2f} GiB, "
            f"launches {launches}")
    report["operators"] = results
    return {"left": left, "right": right, "results": results,
            "order": oracle["order"], "first": oracle["first_by_key"],
            "sets": {op: oracle[op]["k"]
                     for op in ("union", "intersect", "subtract")}}


def phase_distributed_operators(report: dict, main: dict, dist: dict,
                                ops: dict, rows: int) -> dict:
    """Phase 3e: the distributed operators on the phase-3b tables (SHARDS
    shards on the one card), each against numpy (``ops``: phase 3d's
    stable order of the left keys, each key's first row in key order,
    and the key sets)."""
    import numpy as np

    from cylon_tpu_torch import pipeline

    lk, lv, rk, rv = main["data"]
    order, first = ops["order"], ops["first"]
    calls = pipeline.distributed_operator_calls(dist["left"], dist["right"])
    results = {}
    for name, fn in calls.items():
        out, first_s, launches = _first_run(fn)
        info = {}
        if name == "distributed_sort":
            shards = [(c[0].data[:int(n)], c[1].data[:int(n)])
                      for c, n in zip(out.shards, out.counts)]
            for i, (k, _) in enumerate(shards):
                if k.numel() > 1 and bool((k[1:] < k[:-1]).any()):
                    raise AssertionError(f"shard {i} is not sorted")
            for (a, _), (b, _) in zip(shards, shards[1:]):
                if a.numel() and b.numel() and int(a.max()) > int(b.min()):
                    raise AssertionError("shards are not globally ordered")
            got = _cols(out)
            _expect_equal(name, got["k"], lk[order])
            _expect_equal(f"{name} lv", got["lv"], lv[order])
            info["rows_per_shard"] = out.row_counts.tolist()
        elif name == "distributed_unique":
            # a hash shuffle keeps each key's rows in input order, so the
            # kept row is the key's first occurrence; the keys are
            # distinct, so sorting the packed (k, lv) rows sorts by key
            got = _cols(out)
            _expect_equal(name, np.sort(_packed(got["k"], got["lv"])),
                          _packed(lk[first], lv[first]))
        elif name in ("distributed_union", "distributed_intersect",
                      "distributed_subtract"):
            _expect_equal(name, np.sort(_cols(out)["k"]),
                          ops["sets"][name[len("distributed_"):]])
            _expect_zero_tail(name, out)
            if launches["hash_partition"] < 2 * SHARDS:
                raise AssertionError(f"{name}: {launches['hash_partition']} "
                                     "hash_partition launches, expected "
                                     f"at least {2 * SHARDS}")
        elif name == "sum":
            want = float(lv.astype(np.float64).sum())
            if abs(float(out.double()) - want) > F32_SUM_RTOL * abs(want):
                raise AssertionError(f"sum {float(out)} vs oracle {want}")
            info["max_abs_err"] = abs(float(out.double()) - want)
        elif name == "min" and int(out) != int(lk.min()):
            raise AssertionError(f"min {int(out)} vs oracle {lk.min()}")
        del out
        two_sided = name in ("distributed_union", "distributed_intersect",
                             "distributed_subtract")
        r = _time_op(fn, 2 * rows if two_sided else rows)
        r.update(first_run_s=first_s, launches=launches, **info)
        results[name] = r
        log(f"[3e] {name}: best-of-5 {r['best_ms']:.2f} ms -> "
            f"{r['rows_per_s']:.6g} rows/s ({SHARDS} shards on one card), "
            f"first run {first_s:.3f} s, peak "
            f"{r['peak_device_bytes'] / 2**30:.2f} GiB, launches {launches}"
            + (f", rows per shard {info['rows_per_shard']}"
               if "rows_per_shard" in info else ""))
    report["distributed_operators"] = results
    return results


# -- phases 3f, 3g and 3h: string keys ----------------------------------------

def _string_launch_check(label: str, launches: dict) -> None:
    """Both scan kernels ran, and murmur3 did not: every shuffle key on the
    string paths is a string, which hashes with ``ops/hashing.py``."""
    if launches["scan_1d"] < 1 or launches["segmented_scan"] < 1:
        raise AssertionError(f"{label}: the scan kernels did not run: "
                             f"{launches}")
    if launches["hash_partition"] != 0:
        raise AssertionError(f"{label}: murmur3 ran on string keys: "
                             f"{launches}")


def _check_string_groups(label: str, groups, joined, oracle: dict):
    """Phase 3's oracle on the string-key join -> group-by: join and group
    counts exact, group keys decoded on the card (prefix, length 18,
    digits) equal to the oracle's int keys, SUM and MEAN within rtol.
    Returns (sum, mean) max abs errors."""
    import numpy as np

    from cylon_tpu_torch import pipeline

    jm, g = joined.row_count, groups.row_count
    if (jm, g) != (oracle["join"], oracle["groups"]):
        raise AssertionError(f"{label}: join {jm} groups {g}, oracle join "
                             f"{oracle['join']} groups {oracle['groups']}")
    keys, sums, means = [], [], []
    for cols, n in zip(groups.shards, groups.counts):
        n = int(n)
        for c in cols:
            if not (bool(c.validity[:n].all())
                    and not bool(c.validity[n:].any())):
                raise AssertionError(f"{label}: group validity is not the "
                                     "live prefix")
        keys.append(pipeline.name_keys(cols[0], n).cpu().numpy())
        sums.append(cols[1].data[:n].cpu().numpy())
        means.append(cols[2].data[:n].cpu().numpy())
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    return _check_groups(oracle, keys[order].astype(np.int32),
                         np.concatenate(sums)[order],
                         np.concatenate(means)[order], label)


def _timed_calls(module, name: str, fn):
    """(result of ``fn()``, device ms spanned by the calls of
    ``module.name`` made during it, the number of those calls, device ms
    spanned by the whole run): CUDA events bracket each call on the
    stream."""
    import torch

    orig = getattr(module, name)
    spans = []

    def wrapped(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kw)
        stop.record()
        spans.append((start, stop))
        return out

    setattr(module, name, wrapped)
    try:
        torch.cuda.synchronize()
        run0 = torch.cuda.Event(enable_timing=True)
        run1 = torch.cuda.Event(enable_timing=True)
        run0.record()
        out = fn()
        run1.record()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, orig)
    return (out, sum(a.elapsed_time(b) for a, b in spans), len(spans),
            run0.elapsed_time(run1))


def phase_string_join(report: dict, main: dict, rows: int,
                      profile: bool = False) -> None:
    """Phase 3f: phase 3's data with every int key rendered as TPC-H's
    ``c_name`` ("Customer#%09d", 18 bytes in a 32-byte column), one-shard
    Tables on the card, ``string_join_groupby``, phase 3's oracle."""
    import torch

    from cylon_tpu_torch import CylonContext, pipeline

    t0 = time.perf_counter()
    left, right = pipeline.string_tables(CylonContext.Init(), *main["data"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    (groups, joined), first_s, launches = _first_run(
        lambda: pipeline.string_join_groupby(left, right))
    log(f"[3f] string keys, {rows} rows/side, width "
        f"{left.shards[0][0].string_width}: tables built in {build_s:.1f} s;"
        f" first run {first_s:.3f} s launches={launches}")
    _string_launch_check("3f", launches)
    sum_err, mean_err = _check_string_groups("3f", groups, joined,
                                             main["oracle"])
    out_cap = joined.shard_capacity
    del groups, joined
    times, rate, peak = _best_of_5(
        lambda: pipeline.string_join_groupby(left, right), rows)
    if profile:
        phase_profile(report, "strings_single_chip",
                      lambda: pipeline.string_join_groupby(left, right))
    report["string_join"] = {
        "rows_per_side": rows, "width": left.shards[0][0].string_width,
        "build_s": build_s, "launches": launches, "first_run_s": first_s,
        "times_s": times, "rows_per_s": rate, "peak_device_bytes": peak,
        "join_capacity": out_cap, "sum_max_abs_err": sum_err,
        "mean_max_abs_err": mean_err}
    log(f"[3f] oracle: join {main['oracle']['join']} groups "
        f"{main['oracle']['groups']} exact, keys decode; SUM max abs err "
        f"{sum_err:.3g}, MEAN {mean_err:.3g}; best-of-5 "
        f"{min(times) * 1e3:.2f} ms -> {rate:.6g} rows/s; times "
        f"{[round(t * 1e3, 2) for t in times]} ms; peak device memory "
        f"{peak / 2**30:.2f} GiB")


def phase_string_distributed(report: dict, main: dict, rows: int,
                             profile: bool = False) -> None:
    """Phase 3g: the same string tables in SHARDS shards on the one card:
    ``string_join_groupby`` (both shuffles hash the string key with
    ``ops/hashing.py``), then ``distributed_sort`` by the string key (range
    targets on its 4-byte prefix), checked as monotone and a permutation
    of the input."""
    import torch

    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline
    from cylon_tpu_torch.ops import hashing

    lk, lv = main["data"][0], main["data"][1]
    ctx = CylonContext.InitDistributed(MeshConfig(world_size=SHARDS))
    left, right = pipeline.string_tables(ctx, *main["data"])
    (groups, joined), first_s, launches = _first_run(
        lambda: pipeline.string_join_groupby(left, right))
    log(f"[3g] string keys in {SHARDS} shards: first run {first_s:.3f} s "
        f"launches={launches}")
    _string_launch_check("3g", launches)
    sum_err, mean_err = _check_string_groups("3g", groups, joined,
                                             main["oracle"])
    del groups, joined
    _, hash_ms, hash_calls, run_ms = _timed_calls(
        hashing, "hash_columns",
        lambda: pipeline.string_join_groupby(left, right))
    times, rate, peak = _best_of_5(
        lambda: pipeline.string_join_groupby(left, right), rows)
    if profile:
        phase_profile(report, "strings_distributed",
                      lambda: pipeline.string_join_groupby(left, right))
    log(f"[3g] oracle exact, keys decode; SUM max abs err {sum_err:.3g}, "
        f"MEAN {mean_err:.3g}; best-of-5 {min(times) * 1e3:.2f} ms -> "
        f"{rate:.6g} rows/s ({SHARDS} shards on one card); peak "
        f"{peak / 2**30:.2f} GiB; row hash {hash_ms:.2f} ms of the run's "
        f"{run_ms:.2f} device ms ({100 * hash_ms / run_ms:.1f}%, "
        f"{hash_calls} calls)")

    out, sort_first_s, sort_launches = _first_run(
        lambda: left.distributed_sort("k"))
    keys = [pipeline.name_keys(c[0], n) for c, n in zip(out.shards,
                                                        out.counts)]
    for i, k in enumerate(keys):
        if k.numel() > 1 and bool((k[1:] < k[:-1]).any()):
            raise AssertionError(f"3g sort: shard {i} is not sorted")
    for a, b in zip(keys, keys[1:]):
        if a.numel() and b.numel() and int(a.max()) > int(b.min()):
            raise AssertionError("3g sort: shards are not globally ordered")
    got = torch.cat([k.to("cuda") for k in keys])
    want = torch.sort(torch.from_numpy(lk).to("cuda").long()).values
    got_v = torch.cat([c[1].data[:int(n)].to("cuda")
                       for c, n in zip(out.shards, out.counts)])
    if not (torch.equal(got, want) and torch.equal(
            torch.sort(got_v).values,
            torch.sort(torch.from_numpy(lv).to("cuda")).values)):
        raise AssertionError("3g sort: not a permutation of the input")
    per_shard = out.row_counts.tolist()
    del out, keys, got, want, got_v
    sort = _time_op(lambda: left.distributed_sort("k"), rows)
    if profile:
        phase_profile(report, "strings_distributed_sort",
                      lambda: left.distributed_sort("k"))
    sort.update(first_run_s=sort_first_s, launches=sort_launches,
                rows_per_shard=per_shard)
    report["string_distributed"] = {
        "shards": SHARDS, "rows_per_side": rows, "launches": launches,
        "first_run_s": first_s, "times_s": times, "rows_per_s": rate,
        "peak_device_bytes": peak, "sum_max_abs_err": sum_err,
        "mean_max_abs_err": mean_err, "row_hash_device_ms": hash_ms,
        "row_hash_calls": hash_calls, "run_device_ms": run_ms,
        "distributed_sort": sort}
    log(f"[3g] distributed_sort by the string key: monotone, a permutation;"
        f" rows per shard {per_shard}; best-of-5 {sort['best_ms']:.2f} ms "
        f"-> {sort['rows_per_s']:.6g} rows/s, first run {sort_first_s:.3f}"
        f" s, peak {sort['peak_device_bytes'] / 2**30:.2f} GiB, launches "
        f"{sort_launches}")


Q1_SF = 10  # SF100 cut to fit the script's time limit and its host oracle


def _q1_oracle(data: dict) -> dict:
    """numpy bincount oracle of TPC-H Q1 over group codes
    (returnflag * 2 + linestatus, i.e. key order): float64 sums and means
    of the float32 inputs, exact counts."""
    import numpy as np

    from cylon_tpu_torch import pipeline

    m = data["l_shipdate"] <= pipeline.Q1_CUTOFF
    rf = np.searchsorted(np.frombuffer(pipeline.RETURNFLAGS, np.uint8),
                         data["l_returnflag"][0][:, 0])
    ls = np.searchsorted(np.frombuffer(pipeline.LINESTATUSES, np.uint8),
                         data["l_linestatus"][0][:, 0])
    code = (rf * 2 + ls)[m]
    q, ep, d, tax = (data[c][m].astype(np.float64) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = ep * (1 - d)
    cnt = np.bincount(code, minlength=6)

    def s(w):
        return np.bincount(code, weights=w, minlength=6)

    out = {"count_l_discount": cnt, "sum_l_quantity": s(q),
           "mean_l_quantity": s(q) / cnt, "sum_l_extendedprice": s(ep),
           "mean_l_extendedprice": s(ep) / cnt,
           "sum_disc_price": s(disc_price),
           "sum_charge": s(disc_price * (1 + tax)),
           "mean_l_discount": s(d) / cnt}
    return {k: v[cnt > 0] for k, v in out.items()} | {
        "codes": np.flatnonzero(cnt > 0), "rows_selected": int(m.sum())}


def _check_q1(label: str, out, oracle: dict) -> float:
    """Group keys and counts exact, every sum and mean within rtol of the
    float64 oracle; returns the max relative error.  ``out`` is a Table or
    a dict of host columns."""
    import numpy as np

    from cylon_tpu_torch import pipeline

    got = out if isinstance(out, dict) else out.to_numpy()
    rf = np.array([pipeline.RETURNFLAGS.index(x.encode())
                   for x in got["l_returnflag"]])
    ls = np.array([pipeline.LINESTATUSES.index(x.encode())
                   for x in got["l_linestatus"]])
    code = rf * 2 + ls
    order = np.argsort(code)
    _expect_equal(f"{label} groups", code[order], oracle["codes"])
    _expect_equal(f"{label} counts", got["count_l_discount"][order],
                  oracle["count_l_discount"])
    worst = 0.0
    for name, want in oracle.items():
        if name in ("codes", "rows_selected", "count_l_discount"):
            continue
        g = got[name][order].astype(np.float64)
        np.testing.assert_allclose(g, want, rtol=F32_SUM_RTOL,
                                   err_msg=f"{label} {name}")
        worst = max(worst, float(np.max(np.abs(g - want) / np.abs(want))))
    return worst


def phase_tpch_q1(report: dict, profile: bool = False) -> dict:
    """Phase 3h: TPC-H Q1 at SF10 (60,000,000 lineitem rows), on one shard
    and on SHARDS shards of the one card, against a numpy oracle."""
    import torch

    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline

    t0 = time.perf_counter()
    data = pipeline.lineitem(Q1_SF, seed=0)
    oracle = _q1_oracle(data)
    rows = len(data["l_shipdate"])
    log(f"[3h] TPC-H Q1 SF{Q1_SF}: {rows} lineitem rows, "
        f"{oracle['rows_selected']} pass the shipdate filter; data and "
        f"oracle in {time.perf_counter() - t0:.1f} s")
    results = {}
    for shards in (1, SHARDS):
        ctx = (CylonContext.Init() if shards == 1 else
               CylonContext.InitDistributed(MeshConfig(world_size=shards)))
        t = pipeline.lineitem_table(ctx, data)
        out, first_s, launches = _first_run(lambda: pipeline.tpch_q1(t))
        _string_launch_check(f"3h {shards} shard(s)", launches)
        err = _check_q1(f"3h {shards} shard(s)", out, oracle)
        del out
        r = _time_op(lambda: pipeline.tpch_q1(t), rows)
        if profile:
            phase_profile(report, f"tpch_q1_{shards}",
                          lambda: pipeline.tpch_q1(t))
        r.update(first_run_s=first_s, launches=launches,
                 max_rel_err=err)
        results[f"{shards}_shard" + ("s" if shards > 1 else "")] = r
        log(f"[3h] Q1 on {shards} shard(s): groups and counts exact, max "
            f"rel err {err:.3g} (rtol {F32_SUM_RTOL}); best-of-5 "
            f"{r['best_ms']:.2f} ms -> {r['rows_per_s']:.6g} rows/s, first "
            f"run {first_s:.3f} s, peak "
            f"{r['peak_device_bytes'] / 2**30:.2f} GiB, launches {launches}")
        del t
        torch.cuda.empty_cache()
    report["tpch_q1"] = {"sf": Q1_SF, "rows": rows,
                         "rows_selected": oracle["rows_selected"],
                         **results}
    return {"data": data, "oracle": oracle}


# kernel family -> substrings of the profiler's kernel names (first match
# wins; anything else is "other elementwise")
FAMILIES = (
    ("CUDA hash kernel (cuda/murmur3.cu)", ("hash_partition_kernel",)),
    ("CUDA scan kernels (cuda/scan.cu)", ("lookback_scan_kernel",
                                          "tile_scan_kernel",
                                          "fixup_kernel")),
    ("radix sorts (CUB)", ("DeviceRadixSort", "DeviceSegmentedRadixSort",
                           "radixSort")),
    ("torch.bincount", ("kernelHistogram1D",)),
    ("gathers and scatters", ("gpu_index_kernel", "indexFuncLargeIndex",
                              "scatter")),
    ("dtype copies (.to)", ("direct_copy_kernel",)),
    ("arange", ("arange_cuda_out",)),
    ("cat, fills, cumsum, memcpy, memset", (
        "CatArrayBatchedCopy", "FillFunctor", "DeviceScan",
        "fill_reverse_indices", "Memcpy", "Memset")),
)


def kernel_families(rows: list) -> list:
    """Profile rows summed by kernel family: name, launches, device us,
    most first."""
    acc: dict = {}
    for r in rows:
        fam = next((f for f, keys in FAMILIES
                    if any(k in r["name"] for k in keys)),
                   "other elementwise")
        calls, us = acc.get(fam, (0, 0.0))
        acc[fam] = (calls + r["calls"], us + r["device_us"])
    return sorted(({"family": f, "calls": c, "device_us": us}
                   for f, (c, us) in acc.items()),
                  key=lambda r: -r["device_us"])


def phase_profile(report: dict, key: str, fn) -> None:
    """Device time by kernel and by kernel family over one run of ``fn``
    (torch.profiler), and the device's busy share of the run's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue  # host-side ops; their kernels are listed themselves
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append({"name": e.key[:90], "calls": e.count,
                         "device_us": dev_us})
    rows.sort(key=lambda r: -r["device_us"])
    busy = sum(r["device_us"] for r in rows)
    families = kernel_families(rows)
    report.setdefault("profile", {})[key] = {
        "wall_us": wall_us, "device_busy_us": busy, "kernels": rows,
        "families": families}
    log(f"[p] one {key} run: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")
    for r in families:
        log(f"[p]   {r['device_us'] / 1e3:8.3f} ms  x{r['calls']:<5} "
            f"{100 * r['device_us'] / busy:5.1f}%  {r['family']}")
    for r in rows[:15]:
        log(f"[p]   {r['device_us'] / 1e3:8.3f} ms  x{r['calls']:<4} "
            f"{r['name']}")


def phase_stages(report: dict, dist: dict) -> None:
    """Wall time of each stage of one distributed run, each synchronised:
    the two input shuffles (hash, grouping by target, exchange), the
    per-shard join, the two-phase group-by (partial, shuffle, combine)."""
    import torch

    from cylon_tpu_torch import table as table_mod
    from cylon_tpu_torch.parallel import ops as par_ops

    left, right = dist["left"], dist["right"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    cfg = table_mod._join_config(left, right, None, "k", None, None,
                                 "inner", "sort")
    lsh, l_ms = timed(lambda: par_ops.shuffle(left, cfg.left_on))
    rsh, r_ms = timed(lambda: par_ops.shuffle(right, cfg.right_on))
    joined, j_ms = timed(lambda: table_mod._local_join(lsh, rsh, cfg))
    del lsh, rsh
    _, g_ms = timed(lambda: joined.groupby("l_k", {"lv": "sum",
                                                   "rv": "mean"}))
    stages = {"shuffle_left_ms": l_ms, "shuffle_right_ms": r_ms,
              "local_join_ms": j_ms, "groupby_ms": g_ms}
    report["distributed_stages"] = stages
    log(f"[p] distributed stages: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))


# -- phases 3k and 3l: the hash join and the distributed surface --------------

def _rounds() -> dict:
    from cylon_tpu_torch.ops import hash_join

    return dict(hash_join.ROUNDS)


def phase_hash_join(report: dict, main: dict, rows: int,
                    profile: bool = False) -> None:
    """Phase 3k: the main path with ``algo="hash"`` on phase 3's tables."""
    import numpy as np
    import torch

    from cylon_tpu_torch import pipeline
    from cylon_tpu_torch.ops import hash_join

    tables, oracle = main["tables"], main["oracle"]
    torch.cuda.synchronize()
    _reset_launches()
    hash_join.reset_rounds()
    t0 = time.perf_counter()
    m = pipeline.join_count(*tables, algo="hash")
    out_cap = pipeline.cap_round(m)
    count_rounds = _rounds()
    gcols, g, jm = pipeline.join_groupby(*tables, out_cap, algo="hash")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, rounds = _launch_counts(), _rounds()
    gather_rounds = {k: rounds[k] - count_rounds[k] for k in rounds}
    log(f"[3k] join_count(algo=hash)={m} out_cap={out_cap} first run "
        f"{first_s:.3f} s launches={launches} rounds: count "
        f"{count_rounds}, gather {gather_rounds}")
    if m != oracle["join"] or out_cap != main["out_cap"]:
        raise AssertionError(f"hash join count {m} != sort path's "
                             f"{oracle['join']}")
    if launches["scan_1d"] < 1 or launches["segmented_scan"] < 1:
        raise AssertionError(f"hash main path did not go through the scan "
                             f"kernels: {launches}")
    g_n, jm_n = int(g), int(jm)
    if (jm_n, g_n) != (oracle["join"], oracle["groups"]):
        raise AssertionError(f"hash counts: join {jm_n} group {g_n}")
    valid = [c.validity.cpu().numpy() for c in gcols]
    for v in valid:
        if not (v[:g_n].all() and not v[g_n:].any()):
            raise AssertionError("group validity is not the live prefix")
    keys = gcols[0].data[:g_n].cpu().numpy()
    order = np.argsort(keys, kind="stable")  # groups in chain-head order
    sum_err, mean_err = _check_groups(
        oracle, keys[order], gcols[1].data[:g_n].cpu().numpy()[order],
        gcols[2].data[:g_n].cpu().numpy()[order], "hash join")
    log(f"[3k] oracle: join {oracle['join']} groups {oracle['groups']} "
        f"exact; SUM max abs err {sum_err:.3g}, MEAN max abs err "
        f"{mean_err:.3g} (rtol {F32_SUM_RTOL})")
    del gcols, g, jm, valid, keys, order

    times, rate, peak = _best_of_5(
        lambda: pipeline.join_groupby(*tables, out_cap, algo="hash"), rows)
    report["hash_join"] = {
        "rows_per_side": rows, "join_count": m, "groups": oracle["groups"],
        "out_cap": out_cap, "launches": launches, "rounds_count": count_rounds,
        "rounds_gather": gather_rounds, "first_run_s": first_s,
        "times_s": times, "rows_per_s": rate, "peak_device_bytes": peak,
        "sum_max_abs_err": sum_err, "mean_max_abs_err": mean_err}
    log(f"[3k] best-of-5 {min(times) * 1e3:.2f} ms -> {rate:.6g} rows/s; "
        f"times {[round(t * 1e3, 2) for t in times]} ms; peak device "
        f"memory {peak / 2**30:.2f} GiB")
    if profile:
        phase_profile(report, "hash_join", lambda: pipeline.join_groupby(
            *tables, out_cap, algo="hash"))


def _groups_of(t, key: str, cols) -> dict:
    """A group-by's output on the host, ordered by its key."""
    import numpy as np

    out = _cols(t, [key] + list(cols))
    order = np.argsort(out[key], kind="stable")
    return {n: v[order] for n, v in out.items()}


def _expect_close(label: str, got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: {got.shape} vs {want.shape}")
    err = np.abs(got - want)
    bad = np.count_nonzero(~(err <= F32_SUM_RTOL * np.abs(want)))
    if bad:
        raise AssertionError(f"{label}: {bad} values outside rtol "
                             f"{F32_SUM_RTOL}")
    return float(err.max(initial=0.0))


def _distinct_per_key(k, v, rows: int):
    """Distinct float32 values per int32 key in [0, rows): one direct sort
    of (key, value bits) packed into a uint64, then a bincount of the keys
    of the distinct pairs."""
    import numpy as np

    pairs = _distinct(_packed(k, v))
    return np.bincount((pairs >> np.uint64(32)).astype(np.int64),
                       minlength=rows)


def phase_distributed_surface(report: dict, main: dict, dist: dict,
                              rows: int) -> None:
    """Phase 3l: the hash join and the group-bys of the distributed
    surface on phase 3b's tables, and ``broadcast_gather``."""
    import numpy as np

    from cylon_tpu_torch import Table
    from cylon_tpu_torch.ops.groupby import AggOp
    from cylon_tpu_torch.parallel import ops as par_ops

    lk, lv, _, _ = main["data"]
    left, right, ctx = dist["left"], dist["right"], dist["ctx"]
    oracle = main["oracle"]
    t0 = time.perf_counter()
    cnt_l = np.bincount(lk, minlength=rows)
    present = np.flatnonzero(cnt_l)
    sum_l = np.bincount(lk, weights=lv.astype(np.float64),
                        minlength=rows)[present]
    nunique = _distinct_per_key(lk, lv, rows)[present]
    log(f"[3l] numpy oracles in {time.perf_counter() - t0:.1f} s")
    bc_rows = min(1 << 20, rows)
    small = Table.from_numpy(["k", "lv"], [lk[:bc_rows], lv[:bc_rows]],
                             ctx=ctx)
    nunique_aggs = ((1, AggOp.NUNIQUE),)
    calls = {
        "hash_join_groupby": lambda: left.distributed_join(
            right, on="k", algorithm="hash").groupby(
                "l_k", {"lv": "sum", "rv": "mean"}),
        "pipeline_groupby": lambda: left.distributed_sort("k").groupby(
            "k", {"lv": ["sum", "mean"]}, groupby_type="pipeline"),
        "nunique": lambda: left.groupby("k", {"lv": "nunique"}),
        "salted_nunique": lambda: par_ops.distributed_groupby(
            left, (0,), nunique_aggs, 0, salt=4),
        "pre_partitioned": lambda: par_ops.distributed_groupby(
            left.shuffle("k"), (0,), ((1, AggOp.SUM),), 0,
            pre_partitioned=True),
        "broadcast_gather": lambda: par_ops.broadcast_gather(small),
    }
    results, nunique_out = {}, None
    for name, fn in calls.items():
        out, first_s, launches = _first_run(fn)
        info = {}
        if name == "hash_join_groupby":
            g = _groups_of(out, "l_k", ["sum_lv", "mean_rv"])
            info["max_abs_err"] = max(_check_groups(
                oracle, g["l_k"], g["sum_lv"], g["mean_rv"], name))
        elif name == "pipeline_groupby":
            g = _groups_of(out, "k", ["sum_lv", "mean_lv"])
            h = _groups_of(left.groupby("k", {"lv": ["sum", "mean"]}), "k",
                           ["sum_lv", "mean_lv"])
            _expect_equal(f"{name} keys", g["k"], h["k"])
            _expect_equal(f"{name} keys vs numpy", g["k"], present)
            info["max_abs_err"] = _expect_close(f"{name} sum", g["sum_lv"],
                                                sum_l)
            _expect_close(f"{name} vs hash sum", g["sum_lv"], h["sum_lv"])
            _expect_close(f"{name} vs hash mean", g["mean_lv"],
                          h["mean_lv"])
        elif name in ("nunique", "salted_nunique"):
            g = _groups_of(out, "k", ["nunique_lv"])
            _expect_equal(f"{name} keys", g["k"], present)
            _expect_equal(f"{name} counts", g["nunique_lv"], nunique)
            if name == "nunique":
                nunique_out = g
            else:
                _expect_equal(f"{name} vs unsalted", g["nunique_lv"],
                              nunique_out["nunique_lv"])
        elif name == "pre_partitioned":
            g = _groups_of(out, "k", ["sum_lv"])
            shuffled = _groups_of(par_ops.distributed_groupby(
                left.shuffle("k"), (0,), ((1, AggOp.SUM),), 0), "k",
                ["sum_lv"])
            _expect_equal(f"{name} keys", g["k"], shuffled["k"])
            _expect_equal(f"{name} keys vs numpy", g["k"], present)
            _expect_close(f"{name} vs shuffled", g["sum_lv"],
                          shuffled["sum_lv"])
            info["max_abs_err"] = _expect_close(f"{name} sum", g["sum_lv"],
                                                sum_l)
        else:  # broadcast_gather
            if out.row_counts.tolist() != [bc_rows] * out.num_shards:
                raise AssertionError(f"{name}: rows {out.row_counts}")
            for s, (cols, n) in enumerate(zip(out.shards, out.counts)):
                n = int(n)
                _expect_equal(f"{name} shard {s} k",
                              cols[0].data[:n].cpu().numpy(), lk[:bc_rows])
                _expect_equal(f"{name} shard {s} lv",
                              cols[1].data[:n].cpu().numpy(), lv[:bc_rows])
        if name != "broadcast_gather" and launches["hash_partition"] < 1:
            raise AssertionError(f"{name}: the hash kernel did not launch: "
                                 f"{launches}")
        del out
        r = _time_op(fn, bc_rows if name == "broadcast_gather" else
                     2 * rows if name == "hash_join_groupby" else rows,
                     runs=3)
        r.update(first_run_s=first_s, launches=launches, **info)
        results[name] = r
        log(f"[3l] {name}: best-of-3 {r['best_ms']:.2f} ms -> "
            f"{r['rows_per_s']:.6g} rows/s ({SHARDS} shards on one card), "
            f"first run {first_s:.3f} s, peak "
            f"{r['peak_device_bytes'] / 2**30:.2f} GiB, launches {launches}")
    report["distributed_surface"] = results


# -- phase 3t: the shuffle's exchange realizations ----------------------------

# (label, CYLON_TPU_SHUFFLE_PACK, CYLON_TPU_SHUFFLE_COMPRESS)
EXCHANGE_ARMS = (("per_buffer", "0", "0"), ("packed", "1", "0"),
                 ("compressed", "1", "1"))
TASK_ROWS = 1 << 24  # rows of each of 3t (c)'s two tables


def _l_orderkey(n: int, seed: int):
    """int64 l_orderkey of ``n`` lineitem rows as dbgen draws them: orders
    1, 2, ... with 1-7 consecutive lines each (uniform), and each order's
    key made sparse by ``mk_sparse`` (only the first 8 of every 32 keys
    used, TPC-H 4.2.3), so SF-10's 15,000,000 orders span keys up to
    60,000,000.  The lines past row ``n`` are cut (3h's table holds
    60,000,000 rows; dbgen's SF-10 lineitem 59,986,052), and orders past
    15,000,000 enter only where the draw runs short."""
    import numpy as np

    lines = np.random.default_rng(seed).integers(1, 8, n // 4 + n // 400 + 8)
    order = np.repeat(np.arange(1, len(lines) + 1, dtype=np.int64),
                      lines)[:n]
    return ((order >> 3) << 5) | (order & 7)


def _arm_env(pack: str, comp: str):
    from cylon_tpu_torch import config

    return config.knob_env(CYLON_TPU_SHUFFLE_PACK=pack,
                           CYLON_TPU_SHUFFLE_COMPRESS=comp)


def _exchange_metrics() -> dict:
    """The shuffle accounting since the last ``metrics.reset()``."""
    from cylon_tpu_torch.obs import metrics

    snap = metrics.snapshot()
    c = snap["counters"]
    return {k: c.get(f"shuffle.{k}", 0) for k in (
        "exchanges", "broadcasts", "collective_launches", "bytes_sent",
        "bytes_saved")} | {
        "compress_ratio": snap["gauges"].get("shuffle.compress_ratio")}


def _same_bits(label: str, got, want) -> None:
    """Two tables hold the same bits, shard for shard, over every
    capacity (floats by their bits), checked on the card."""
    import torch

    if got.names != want.names or \
            got.row_counts.tolist() != want.row_counts.tolist():
        raise AssertionError(f"{label}: names or row counts differ")
    for s, (gs, ws) in enumerate(zip(got.shards, want.shards)):
        for name, g, w in zip(got.names, gs, ws):
            same = (torch.equal(g.validity, w.validity) and torch.equal(
                g.data.contiguous().view(torch.uint8),
                w.data.contiguous().view(torch.uint8))
                and (g.lengths is None or torch.equal(g.lengths, w.lengths)))
            if not same:
                raise AssertionError(f"{label}: shard {s} column {name} "
                                     "differs")


def _arm_runs(fn, rows: int):
    """(first-run result, record) of ``fn`` under the knobs already set:
    a first run with the launch counters and the metrics zeroed just
    before it and read just after, then best-of-3 ms and peak memory."""
    from cylon_tpu_torch.obs import metrics

    metrics.reset()
    out, first_s, launches = _first_run(fn)
    rec = {"first_run_ms": first_s * 1e3, "launches": launches,
           **_exchange_metrics()}
    rec.update(_time_op(fn, rows, runs=3))
    return out, rec


def _log_arm(tag: str, label: str, rec: dict) -> None:
    log(f"[3t] {tag} {label}: best-of-3 {rec['best_ms']:.2f} ms, first "
        f"run {rec['first_run_ms']:.2f} ms, bytes_sent {rec['bytes_sent']}"
        f", collective launches {rec['collective_launches']}, compress "
        f"ratio {rec['compress_ratio']}, peak "
        f"{rec['peak_device_bytes'] / 2**30:.2f} GiB, kernel launches "
        f"{rec['launches']}")


def phase_exchange(report: dict, main: dict, dist: dict, q1: dict,
                   rows: int, profile: bool = False) -> None:
    """Phase 3t: the shuffle's three exchange realizations (per buffer,
    one packed plane, the plane compressed) on (a) 3b's distributed join
    -> group-by, (b) a hash repartition of TPC-H SF-10 lineitem, (c)
    ``task_shuffle`` and (d) ``broadcast_gather``, each against the
    others bit for bit and against numpy."""
    import numpy as np
    import torch

    from cylon_tpu_torch import Table, pipeline
    from cylon_tpu_torch.obs import metrics
    from cylon_tpu_torch.parallel import ops as par_ops
    from cylon_tpu_torch.parallel import partition, plane
    from cylon_tpu_torch.parallel import shuffle as shuffle_mod
    from cylon_tpu_torch.parallel.task import LogicalTaskPlan, task_shuffle

    left, right, ctx = dist["left"], dist["right"], dist["ctx"]
    out: dict = {}
    t_phase = time.perf_counter()

    # (a) 3b's main path under each realization
    res, base = {}, None
    per_buffer_launches = shuffle_mod.buffer_count(left.shards[0])
    for label, pack, comp in EXCHANGE_ARMS:
        with _arm_env(pack, comp):
            (groups, joined), rec = _arm_runs(
                lambda: pipeline.distributed_join_groupby(left, right),
                2 * rows)
            if profile and comp == "0":
                phase_profile(report, f"exchange_{label}",
                              lambda: pipeline.distributed_join_groupby(
                                  left, right))
            # the join's two shuffles alone: the gauge keeps only the last
            # exchange, so it is read before a group-by's shuffle overwrites
            metrics.reset()
            left.distributed_join(right, on="k")
            rec["join_alone"] = _exchange_metrics()
        ja = rec["join_alone"]
        want_launches = 2 * (1 if pack == "1" else per_buffer_launches)
        want_bytes = 2 * rows * par_ops._row_bytes(
            left.shards[0], pack == "1") if comp == "0" else None
        if ja["exchanges"] != 2 or ja["collective_launches"] != want_launches \
                or (want_bytes is not None and ja["bytes_sent"] != want_bytes):
            raise AssertionError(f"3t (a) {label}: join accounting {ja}, "
                                 f"want 2 exchanges, {want_launches} "
                                 f"launches, {want_bytes} bytes")
        # three exchanges: the join's two and the group-by's partials'
        if rec["exchanges"] != 3 or (pack == "1") != (
                rec["collective_launches"] == 3):
            raise AssertionError(f"3t (a) {label}: accounting {rec}")
        if comp == "1" and ja["compress_ratio"] != 1.5:
            raise AssertionError(f"3t (a) {label}: compress ratio "
                                 f"{ja['compress_ratio']}, want 1.5")
        if rec["launches"]["hash_partition"] < 3 * SHARDS:
            raise AssertionError(f"3t (a) {label}: hash kernel launches "
                                 f"{rec['launches']}")
        if base is None:
            g = _groups_of(groups, "l_k", ["sum_lv", "mean_rv"])
            rec["max_abs_err"] = max(_check_groups(
                main["oracle"], g["l_k"], g["sum_lv"], g["mean_rv"],
                f"3t (a) {label}"))
            base = (groups, joined)
        else:
            _same_bits(f"3t (a) {label} groups", groups, base[0])
            _same_bits(f"3t (a) {label} joined", joined, base[1])
        res[label] = rec
        _log_arm("(a)", label, rec)
        del groups, joined
    out["join_groupby"] = res
    del base

    # (b) a low-cardinality hash repartition: TPC-H SF-10 lineitem
    data = dict(q1["data"])
    n = len(data["l_shipdate"])
    data["l_orderkey"] = _l_orderkey(n, seed=1)
    t = pipeline.lineitem_table(ctx, data)
    spec = plane.build_spec(
        t.shards[0], partition.column_stats(t.shards, t.counts, ctx.devices),
        t.num_shards, t.shard_capacity)
    encodings = dict(zip(t.names, spec))
    for flag in ("l_returnflag", "l_linestatus"):
        if encodings[flag][0] != "dict":
            raise AssertionError(f"3t (b): {flag} encodes as "
                                 f"{encodings[flag]}, not a dictionary")
    res, base = {}, None
    for label, pack, comp in EXCHANGE_ARMS:
        with _arm_env(pack, comp):
            shuffled, rec = _arm_runs(lambda: t.shuffle("l_orderkey"), n)
        if rec["exchanges"] != 1 or rec["collective_launches"] != (
                1 if pack == "1" else shuffle_mod.buffer_count(t.shards[0])):
            raise AssertionError(f"3t (b) {label}: {rec}")
        if base is None:
            rec["q1_max_rel_err"] = _check_q1(
                f"3t (b) {label}", pipeline.tpch_q1(shuffled), q1["oracle"])
            base = shuffled
        else:
            _same_bits(f"3t (b) {label}", shuffled, base)
        res[label] = rec
        _log_arm("(b)", label, rec)
        del shuffled
    out["lineitem_shuffle"] = {"rows": n, "spec": [list(e) for e in spec],
                               **res}
    log(f"[3t] (b) {n} lineitem rows, spec {encodings}; Q1 on the "
        f"shuffled table equals 3h's oracle")
    del t, base, data

    # (c) task_shuffle: two 2^24-row tables, each split into two logical
    # tables, four task ids on four workers
    lk, lv, rk, rv = main["data"]
    half = TASK_ROWS // 2
    parts = [(lk[:half], lv[:half]), (lk[half:TASK_ROWS], lv[half:TASK_ROWS]),
             (rk[:half], rv[:half]), (rk[half:TASK_ROWS], rv[half:TASK_ROWS])]
    tables = [Table.from_numpy(["k", "v"], list(p), ctx=ctx) for p in parts]
    mapping = {0: 3, 1: 2, 2: 1, 3: 0}
    tplan = LogicalTaskPlan(mapping, SHARDS)
    res, base = {}, None
    for label, pack, comp in EXCHANGE_ARMS[:2]:
        with _arm_env(pack, comp):
            outs, rec = _arm_runs(lambda: task_shuffle(tables, [0, 1, 2, 3],
                                                       tplan), 2 * TASK_ROWS)
        if rec["exchanges"] != 1 or rec["collective_launches"] != (
                1 if pack == "1" else 6):
            raise AssertionError(f"3t (c) {label}: {rec}")
        if base is None:
            for task, (o, (k, v)) in enumerate(zip(outs, parts)):
                counts = o.row_counts.tolist()
                if counts[mapping[task]] != len(k) or sum(counts) != len(k):
                    raise AssertionError(f"3t (c) task {task}: rows "
                                         f"{counts}")
                cols, cnt = o.shards[mapping[task]], counts[mapping[task]]
                got = torch.sort((cols[0].data[:cnt].to(torch.int64) << 32)
                                 | (cols[1].data[:cnt].view(torch.int32)
                                    .to(torch.int64) & 0xFFFFFFFF)).values
                want = np.sort(_packed(k, v)).view(np.int64)
                if not torch.equal(got.cpu(), torch.from_numpy(want)):
                    raise AssertionError(f"3t (c) task {task}: rows differ "
                                         "from its input's")
            base = outs
        else:
            for task, (o, b) in enumerate(zip(outs, base)):
                _same_bits(f"3t (c) {label} task {task}", o, b)
        res[label] = rec
        _log_arm("(c)", label, rec)
        del outs
    out["task_shuffle"] = res
    del base, tables

    # (d) broadcast_gather of 3l (f)'s 2^20-row table
    bc_rows = min(1 << 20, rows)
    small = Table.from_numpy(["k", "lv"], [lk[:bc_rows], lv[:bc_rows]],
                             ctx=ctx)
    res, base = {}, None
    for label, pack, comp in EXCHANGE_ARMS[:2]:
        with _arm_env(pack, comp):
            bc, rec = _arm_runs(lambda: par_ops.broadcast_gather(small),
                                bc_rows)
        want = 1 if pack == "1" else 1 + shuffle_mod.buffer_count(
            small.shards[0])
        if rec["broadcasts"] != 1 or rec["collective_launches"] != want:
            raise AssertionError(f"3t (d) {label}: {rec}, want {want} "
                                 "all-gathers")
        if base is None:
            if bc.row_counts.tolist() != [bc_rows] * SHARDS:
                raise AssertionError(f"3t (d): rows {bc.row_counts}")
            _expect_equal("3t (d) k", bc.shards[0][0].data[:bc_rows]
                          .cpu().numpy(), lk[:bc_rows])
            base = bc
        else:
            _same_bits(f"3t (d) {label}", bc, base)
        res[label] = rec
        _log_arm("(d)", label, rec)
    out["broadcast_gather"] = res
    report["exchange"] = out
    report["exchange_seconds"] = time.perf_counter() - t_phase
    log(f"[3t] passed in {report['exchange_seconds']:.1f} s: every "
        "realization bit-identical, the accounting as predicted")


def exchange_launches(report: dict) -> dict:
    """Per kernel, its launches summed over the first runs of phase 3t."""
    total: dict = {}
    for case in report.get("exchange", {}).values():
        for rec in case.values():
            if isinstance(rec, dict) and "launches" in rec:
                for k, n in rec["launches"].items():
                    total[k] = total.get(k, 0) + n
    return total


# -- phase 3u: the distributed path through a process group ------------------

def _live_on_card(t, name: str):
    """Column ``name``'s live rows of every shard, concatenated on the
    card in shard order."""
    import torch

    j = t.names.index(name)
    return torch.cat([cols[j].data[:int(n)]
                      for cols, n in zip(t.shards, t._local_row_counts())])


def phase_process_group(report: dict, main: dict, dist: dict,
                        rows: int) -> None:
    """Phase 3u: 3b's tables on a context over an NCCL group of one rank
    (``MeshConfig(num_processes=1)``, a free port on this host) holding
    SHARDS shards on the card: ``distributed_join_groupby`` through the
    group's collectives (the count all-gather, one ``all_to_all_single``
    per exchanged buffer, self included), checked against 3b's oracle on
    the card and shard for shard against 3b's output; the launch counters
    and the exchange metrics zeroed just before the first run and read
    just after; best-of-3 ms and rows/s, peak device memory.  Ends with
    ``Finalize()``, which leaves the group."""
    import torch

    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline
    from cylon_tpu_torch.obs import metrics

    t_phase = time.perf_counter()
    oracle = main["oracle"]
    ctx = CylonContext.InitDistributed(MeshConfig(world_size=SHARDS,
                                                  num_processes=1))
    try:
        if ctx.group.backend != "nccl" or ctx.GetWorldSize() != SHARDS:
            raise AssertionError(f"3u: {ctx!r} is not one NCCL rank of "
                                 f"{SHARDS} shards")
        left, right = pipeline.distributed_tables(ctx, *main["data"])
        ctx.Barrier()
        metrics.reset()
        _reset_launches()
        t0 = time.perf_counter()
        groups, joined = pipeline.distributed_join_groupby(left, right)
        ctx.Barrier()
        first_s = time.perf_counter() - t0
        launches = _launch_counts()
        counters = metrics.snapshot()["counters"]
        exch = {k: counters.get(f"shuffle.{k}", 0) for k in (
            "exchanges", "collective_launches", "counts_gathers",
            "bytes_sent")}
        log(f"[3u] one NCCL rank, {SHARDS} shards on "
            f"{sorted({str(d) for d in ctx.devices})}: first run "
            f"{first_s:.3f} s launches={launches} exchange={exch}")
        if launches["hash_partition"] < 3 * SHARDS \
                or launches["scan_1d"] < 1 or launches["segmented_scan"] < 1:
            raise AssertionError(f"3u did not go through the kernels: "
                                 f"{launches}")
        if exch["exchanges"] != 3 or exch["counts_gathers"] != 3:
            raise AssertionError(f"3u: not three exchanges with their count "
                                 f"gathers: {exch}")

        jm, g = joined.row_count, groups.row_count
        if (jm, g) != (oracle["join"], oracle["groups"]):
            raise AssertionError(f"3u counts: join {jm} group {g}, oracle "
                                 f"join {oracle['join']} group "
                                 f"{oracle['groups']}")
        k = _live_on_card(groups, "l_k")
        order = torch.argsort(k)
        if not torch.equal(k[order].long(), _card(oracle["keys"]).long()):
            raise AssertionError("3u: group keys differ from the oracle")
        sum_err = _card_rtol("3u SUM", _live_on_card(groups, "sum_lv")[order],
                             _card(oracle["sum"]))
        mean_err = _card_rtol("3u MEAN",
                              _live_on_card(groups, "mean_rv")[order],
                              _card(oracle["mean"]))
        del k, order
        want_groups, want_joined = pipeline.distributed_join_groupby(
            dist["left"], dist["right"])
        for label, got, want in (("groups", groups, want_groups),
                                 ("joined", joined, want_joined)):
            _same_bits(f"3u {label} against 3b's", got, want)
        per_shard = joined.row_counts.tolist()
        log(f"[3u] oracle: join {jm} groups {g} exact; SUM max abs err "
            f"{sum_err:.3g}, MEAN max abs err {mean_err:.3g} (rtol "
            f"{F32_SUM_RTOL}); join rows per shard {per_shard}, shard for "
            "shard equal to 3b's (joined and groups, every buffer's bits)")
        del groups, joined, want_groups, want_joined
        resident = torch.cuda.memory_allocated()
        timed = _time_op(lambda: pipeline.distributed_join_groupby(
            left, right), 2 * rows, runs=3)
        del left, right
    finally:
        ctx.Finalize()
    report["process_group"] = {
        "backend": "nccl", "ranks": 1, "shards": SHARDS,
        "rows_per_side": rows, "join_count": jm, "groups": g,
        "launches": launches, "exchange": exch, "first_run_s": first_s,
        "join_rows_per_shard": per_shard, "sum_max_abs_err": sum_err,
        "mean_max_abs_err": mean_err, "resident_bytes_before": resident,
        **timed, "phase_seconds": time.perf_counter() - t_phase}
    log(f"[3u] best-of-3 {timed['best_ms']:.2f} ms -> "
        f"{timed['rows_per_s']:.6g} rows/s (one NCCL rank, {SHARDS} shards "
        f"on one card); times {[round(t, 2) for t in timed['times_ms']]} ms;"
        f" peak device memory {timed['peak_device_bytes'] / 2**30:.2f} GiB"
        f" ({resident / 2**30:.2f} GiB resident before the runs); phase "
        f"{report['process_group']['phase_seconds']:.1f} s")


# -- phase 3ac: the local kernels' one realization ----------------------------

LEXSORT_ROWS = 1 << 27  # the main path's combined sort: both sides' rows


def _same_columns(label: str, got, want) -> None:
    """Group columns and counts of two ``join_groupby`` results, bit for
    bit on the card (floats by their bits)."""
    import torch

    (gc, g, jm), (wc, wg, wjm) = got, want
    if int(g) != int(wg) or int(jm) != int(wjm):
        raise AssertionError(f"{label}: counts differ")
    for i, (a, b) in enumerate(zip(gc, wc)):
        if not (torch.equal(a.validity, b.validity) and torch.equal(
                a.data.contiguous().view(torch.uint8),
                b.data.contiguous().view(torch.uint8))):
            raise AssertionError(f"{label}: group column {i} differs")


def _realization_arm(fn, rows: int, check) -> dict:
    """One run, its launches the counters' growth across it (the phase's
    counters keep counting), its outputs held by ``check``, then
    best-of-3 ms."""
    import torch

    torch.cuda.synchronize()
    before = _launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in _launch_counts().items()}
    check(out)
    del out
    return {"first_run_ms": first_s * 1e3, "launches": launches,
            **_time_op(fn, rows, runs=3)}


def phase_realizations(report: dict, main: dict, dist: dict, rows: int,
                       device: str = "cuda") -> None:
    """Phase 3ac: the local kernels' one realization (scatter-realized
    permutations and compactions, ``torch.sort`` of the packed key) on
    the main paths' tables, each run's outputs bit for bit a first run's:
    (a) phase 3's ``join_groupby`` and 3b's ``distributed_join_groupby``,
    best-of-3; (b) ``lexsort_indices`` alone at the combined shape (2^27
    rows), best-of-3; (c) the 64-bit audit (``analysis/dtype_audit.py``)
    of one narrow run of phase 3; (d) the device-memory watermark against
    the live tables' bytes.  The launch counters are zeroed at the start
    and read at the end: every run counts.  ``device="cpu"`` with CPU
    tables rehearses the control flow here."""
    import torch

    from cylon_tpu_torch import dtypes, pipeline
    from cylon_tpu_torch.analysis.dtype_audit import dtype_audit
    from cylon_tpu_torch.column import Column
    from cylon_tpu_torch.obs import metrics
    from cylon_tpu_torch.ops import keys

    t_phase = time.perf_counter()
    dev = torch.device(device)
    tables, out_cap = main["tables"], main["out_cap"]
    left, right = dist["left"], dist["right"]
    _reset_launches()
    rec: dict = {}

    def single():
        return pipeline.join_groupby(*tables, out_cap)

    def distributed():
        return pipeline.distributed_join_groupby(left, right)

    # (a) the main paths
    default = single()
    rec["single_chip"] = _realization_arm(
        single, 2 * rows, lambda out: _same_columns("3ac single", out,
                                                    default))
    want_groups, want_joined = distributed()

    def same_dist(out):
        _same_bits("3ac 3b groups", out[0], want_groups)
        _same_bits("3ac 3b joined", out[1], want_joined)

    rec["distributed"] = _realization_arm(distributed, 2 * rows, same_dist)
    del want_groups, want_joined

    # (b) lexsort alone at 2^27
    gen = torch.Generator(device=dev).manual_seed(5)
    n = LEXSORT_ROWS
    kcol = torch.randint(0, n, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    ops = keys.build_operands(
        [Column(kcol, torch.ones(n, dtype=torch.bool, device=dev), None,
                dtypes.int32)], torch.tensor(n - 7, device=dev), n)
    want_perm, want_words = keys.lexsort_indices(ops, n)

    def same_lexsort(out):
        perm, words = out
        if not (torch.equal(perm, want_perm) and all(
                torch.equal(a, b) for a, b in zip(words, want_words))):
            raise AssertionError("3ac lexsort: permutation or words differ "
                                 "between runs")

    rec["lexsort"] = _realization_arm(lambda: keys.lexsort_indices(ops, n),
                                      n, same_lexsort)
    del kcol, ops, want_perm, want_words

    # (c) the 64-bit audit of one narrow run of the main path
    out, audit = dtype_audit(single)
    _same_columns("3ac audited run", out, default)
    del out, default
    rec["dtype_audit"] = {
        "sites": [list(r) for r in audit.table()],
        "wide_bytes": audit.wide_bytes, "total_bytes": audit.total_bytes,
        "share": audit.share}

    # (d) the watermark holds at least the live tables
    live = sum(c.data.nbytes + c.validity.nbytes
               for c in (*tables[0], *tables[2]))
    live += sum(c.data.nbytes + c.validity.nbytes
                for t in (left, right) for shard in t.shards for c in shard)
    metrics.reset()
    mark = metrics.record_hbm_watermark(dev)
    if mark < live or metrics.snapshot()["gauges"]["hbm.live_bytes"] != mark:
        raise AssertionError(f"3ac watermark {mark} below the live tables' "
                             f"{live} bytes")
    rec["watermark"] = {"hbm_live_bytes": mark, "tables_bytes": live}
    rec["launches"] = _launch_counts()
    rec["phase_seconds"] = time.perf_counter() - t_phase
    report["realizations"] = rec

    for part in ("single_chip", "distributed", "lexsort"):
        r = rec[part]
        log(f"[3ac] {part}: best-of-3 {r['best_ms']:.2f} ms, first run "
            f"{r['first_run_ms']:.2f} ms, peak "
            f"{r['peak_device_bytes'] / 2**30:.2f} GiB, launches "
            f"{r['launches']}; bit for bit the first run")
    for site, op, dt, count, nbytes in audit.table():
        log(f"[3ac] 64-bit site {site} {op} {dt}: {count} ops, {nbytes} B "
            f"({nbytes / audit.total_bytes:.2%} of all output bytes)")
    log(f"[3ac] 64-bit outputs {audit.wide_bytes} of {audit.total_bytes} B "
        f"({audit.share:.2%}); watermark {mark} B >= tables {live} B; "
        f"launches {rec['launches']}; phase {rec['phase_seconds']:.1f} s")


# -- phases 3i and 3j: out of core --------------------------------------------

def _host_memory() -> dict:
    """The host's MemTotal and MemAvailable (/proc/meminfo) and this
    process's peak resident set, in bytes."""
    import resource

    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    out["peak_rss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return out


def _check_out_of_core(label: str, res: dict, stats: dict, oracle: dict):
    """A range-mode run's groups come out in ascending key order (passes
    are ascending key ranges): keys and group count exact, SUM and MEAN
    within rtol of the float64 oracle."""
    if stats["mode"] != "range":
        raise AssertionError(f"{label}: planned {stats['mode']}, not range")
    if stats["groups"] != oracle["groups"]:
        raise AssertionError(f"{label}: {stats['groups']} groups, oracle "
                             f"{oracle['groups']}")
    return _check_groups(oracle, res["key"], res["agg0"], res["agg1"], label)


def phase_out_of_core(report: dict, rows: int = OOC_ROWS,
                      passes: int = OOC_PASSES, profile: bool = False) -> list:
    """Phase 3i: the main path past the card's memory, one sweep of the
    out-of-core engine, counters zeroed just before it.  Returns the
    generated ``[lk, lv, rk, rv]`` for phases 3m-3p."""
    import torch

    from cylon_tpu_torch import pipeline

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    data = pipeline.make_data(rows, pipeline.SEED)
    gen_s = time.perf_counter() - t0
    log(f"[3i] {rows} rows per side generated in {gen_s:.1f} s; host "
        f"{_host_memory()}")
    t0 = time.perf_counter()
    oracle = _oracle(data, rows)
    oracle_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    res, stats = pipeline.out_of_core_join_groupby(data, passes)
    torch.cuda.synchronize()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    sweep = {k: stats.get(k) for k in (
        "passes", "mode", "chunk_cap", "cap_l", "cap_r", "out_cap",
        "groups", "parts_run", "oom_splits", "retries", "plan_seconds",
        "run_seconds", "total_seconds")}
    sweep.update(launches=launches, peak_device_bytes=peak,
                 host=_host_memory())
    log(f"[3i] sweep: {json.dumps(sweep)}")
    if launches["scan_1d"] < stats["passes"] \
            or launches["segmented_scan"] < stats["passes"]:
        raise AssertionError(f"the sweep did not run both scan kernels in "
                             f"every pass: {launches}")
    sum_err, mean_err = _check_out_of_core("out of core", res, sweep, oracle)
    del res, oracle
    gc.collect()
    if profile:
        phase_profile(report, "out_of_core",
                      lambda: pipeline.out_of_core_join_groupby(data, passes))
    out = {"rows_per_side": rows, "passes": passes, "generate_s": gen_s,
           "oracle_s": oracle_s, "sweeps": [sweep],
           "steady_rows_per_s": 2 * rows / sweep["run_seconds"],
           "cold_rows_per_s": 2 * rows / sweep["total_seconds"],
           "peak_device_bytes": peak,
           "base_device_bytes": base, "sum_max_abs_err": sum_err,
           "mean_max_abs_err": mean_err, "host": _host_memory()}
    report["out_of_core"] = out
    log(f"[3i] oracle: {sweep['groups']} groups exact; SUM max abs err "
        f"{sum_err:.3g}, MEAN max abs err {mean_err:.3g} (rtol "
        f"{F32_SUM_RTOL}); steady {out['steady_rows_per_s']:.6g} rows/s, "
        f"cold {out['cold_rows_per_s']:.6g} rows/s, peak device "
        f"{out['peak_device_bytes'] / 2**30:.2f} GiB over "
        f"{base / 2**30:.2f} GiB resident")
    return list(data)


def _sorted_groups(res: dict):
    import numpy as np

    order = np.argsort(res["key"], kind="stable")
    return [np.asarray(res[k])[order] for k in ("key", "agg0", "agg1")]


# cut from ROWS for the script's time once 3aa came (PERF.md §4)
OOM_ROWS = ROWS // 2


def phase_oom_refinement(report: dict, rows: int = OOM_ROWS) -> None:
    """Phase 3j: a real device OOM refines the plan.  The engine at 2 and
    4 passes, uncapped, gives each run's peak reserved memory; then the
    caching allocator is capped between the two and 2 passes must split
    and still equal the uncapped run."""
    import numpy as np
    import torch

    from cylon_tpu_torch import pipeline

    data = pipeline.make_data(rows, pipeline.SEED)
    total = torch.cuda.get_device_properties(0).total_memory
    runs = {}
    for passes in (2, 4):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, stats = pipeline.out_of_core_join_groupby(data, passes)
        torch.cuda.synchronize()
        runs[passes] = (res, stats, torch.cuda.max_memory_reserved())
    # the cap counts everything this process holds on the card, so the
    # peaks (absolute reserved bytes) already include what was resident
    cap = (runs[2][2] + runs[4][2]) // 2
    fraction = cap / total
    if not runs[4][2] < cap < runs[2][2]:
        raise AssertionError(f"no room between the peaks: {runs[4][2]} "
                             f"< {cap} < {runs[2][2]}")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(fraction)
        torch.cuda.reset_peak_memory_stats()
        res, stats = pipeline.out_of_core_join_groupby(data, 2)
        torch.cuda.synchronize()
        capped_peak = torch.cuda.max_memory_reserved()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    if stats.get("oom_splits", 0) < 1:
        raise AssertionError(f"capped run did not split: {stats}")
    want = _sorted_groups(runs[2][0])
    got = _sorted_groups(res)
    if not np.array_equal(got[0], want[0]) \
            or stats["groups"] != runs[2][1]["groups"]:
        raise AssertionError("capped run's groups differ from the uncapped")
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64),
                                   rtol=F32_SUM_RTOL)
    keep = ("passes", "mode", "cap_l", "cap_r", "out_cap", "parts_run",
            "oom_splits", "plan_seconds", "run_seconds", "total_seconds")
    out = {"rows_per_side": rows, "total_device_bytes": total,
           "cap_bytes": cap, "fraction": fraction,
           "capped_peak_reserved_bytes": capped_peak,
           "uncapped": {p: {**{k: runs[p][1].get(k) for k in keep},
                            "peak_reserved_bytes": runs[p][2]}
                        for p in (2, 4)},
           "capped": {k: stats.get(k) for k in keep},
           "groups": stats["groups"]}
    report["oom_refinement"] = out
    log(f"[3j] {json.dumps(out)}")


# -- phases 3m-3r: the rest of the out-of-core rung ---------------------------

def _ooc_call(label: str, fn):
    """Run one out-of-core entry point with the launch counters zeroed
    just before it and read just after: (result, stats, record), the
    record holding the stats, launches, first-call seconds, peak device
    memory over the memory allocated before the call, and host memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res, stats = fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = _launch_counts()
    rec = {"stats": stats, "launches": launches, "call_s": call_s,
           "peak_device_bytes": torch.cuda.max_memory_allocated() - base,
           "base_device_bytes": base, "host": _host_memory()}
    log(f"[{label}] {json.dumps(rec, default=str)}")
    return res, stats, rec


def _card(a):
    """A host array as a CUDA tensor (the checks run on the card: numpy
    takes seconds per pass over 2^29 rows on the card's host)."""
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _card_dense(label: str, keys, rows: int, *values):
    """Per-group host ``values`` scattered on the card into dense float64
    arrays over ``[0, rows)``, after checking that every key is in range
    and appears once: (present mask, dense arrays), CUDA tensors."""
    import torch

    k = _card(keys).long()
    if k.numel() and (int(k.min()) < 0 or int(k.max()) >= rows):
        raise AssertionError(f"{label}: a group key is out of range")
    seen = torch.bincount(k, minlength=rows)
    if int(seen.max()) > 1:
        raise AssertionError(f"{label}: a group key appears twice")
    present = seen > 0
    del seen
    dense = []
    for v in values:
        d = torch.zeros(rows, dtype=torch.float64, device="cuda")
        d[k] = _card(v).double()
        dense.append(d)
    return present, dense


def _card_rtol(label: str, got, want) -> float:
    """Max abs error of ``got`` against the float64 ``want`` (CUDA
    tensors); raises if any value is outside ``F32_SUM_RTOL`` of it."""
    err = (got.double() - want).abs()
    bad = int((~(err <= F32_SUM_RTOL * want.abs())).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} values outside rtol "
                             f"{F32_SUM_RTOL} of the float64 oracle")
    return float(err.max()) if err.numel() else 0.0


def phase_ooc_groupby(report: dict, data, prefix: dict,
                      passes: int = OOC_PASSES, profile: bool = False) -> None:
    """Phase 3m: ``chunked_groupby`` of the first ``prefix["rows"]`` rows
    of 3i's left table by ``k`` with SUM, MEAN and COUNT of the value,
    against their numpy ``bincount``s with and without weights
    (``_prefix_oracle``); both scan kernels must launch in every pass."""
    import torch

    from cylon_tpu_torch import pipeline

    rows = prefix["rows"]
    lk, lv = data[0][:rows], data[1][:rows]
    res, stats, rec = _ooc_call("3m", lambda: pipeline.out_of_core_groupby(
        lk, lv, passes))
    launches = rec["launches"]
    if launches["segmented_scan"] < stats["passes"] \
            or launches["scan_1d"] < stats["passes"]:
        raise AssertionError(f"3m: the scan kernels did not launch in every "
                             f"pass: {launches}")
    t0 = time.perf_counter()
    cnt, sums = _card(prefix["cnt"]), _card(prefix["sums"])
    want_groups = int((cnt > 0).sum())
    if stats["groups"] != want_groups:
        raise AssertionError(f"3m: {stats['groups']} groups, oracle "
                             f"{want_groups}")
    present, (g_cnt, g_sum, g_mean) = _card_dense(
        "3m", res["k"], OOC_ROWS, res["count_v"], res["sum_v"],
        res["mean_v"])
    del res
    if not torch.equal(present, cnt > 0):
        raise AssertionError("3m: the group keys differ from the oracle")
    if not torch.equal(g_cnt[present].long(), cnt[present]):
        raise AssertionError("3m: a COUNT differs from the oracle")
    sum_err = _card_rtol("3m SUM", g_sum[present], sums[present])
    mean_err = _card_rtol("3m MEAN", g_mean[present],
                          sums[present] / cnt[present])
    del cnt, sums, present, g_cnt, g_sum, g_mean
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    if profile:
        phase_profile(report, "ooc_groupby",
                      lambda: pipeline.out_of_core_groupby(lk, lv, passes))
    rec.update(rows=rows, passes=passes, check_s=check_s,
               groups=want_groups, sum_max_abs_err=sum_err,
               mean_max_abs_err=mean_err,
               cold_rows_per_s=rows / stats["total_seconds"],
               steady_rows_per_s=rows / stats["run_seconds"])
    report["ooc_groupby"] = rec
    log(f"[3m] {want_groups} groups exact, COUNT exact; SUM max abs err "
        f"{sum_err:.3g}, MEAN {mean_err:.3g} (rtol {F32_SUM_RTOL}); cold "
        f"{rec['cold_rows_per_s']:.6g} rows/s, {rec['call_s']:.2f} s")


def _prefix_oracle(data, rows: int, domain: int = OOC_ROWS) -> dict:
    """numpy ``bincount``s, with and without weights, of the first
    ``rows`` rows of 3i's left table (keys in ``[0, domain)``): the
    oracle of phases 3n and 3o."""
    import numpy as np

    t0 = time.perf_counter()
    k, v = data[0][:rows], data[1][:rows]
    out = {"rows": rows, "cnt": np.bincount(k, minlength=domain),
           "sums": np.bincount(k, weights=v.astype(np.float64),
                               minlength=domain)}
    out["oracle_s"] = time.perf_counter() - t0
    return out


def phase_ooc_unique(report: dict, data, oracle: dict,
                     passes: int = OOC_PASSES,
                     domain: int = OOC_ROWS) -> None:
    """Phase 3n: ``chunked_unique`` of the first ``oracle["rows"]`` keys
    of 3i's left table against the nonzero count of their bincount, the
    keys as a set."""
    import torch

    from cylon_tpu_torch import pipeline

    rows = oracle["rows"]
    res, stats, rec = _ooc_call("3n", lambda: pipeline.out_of_core_unique(
        data[0][:rows], passes))
    t0 = time.perf_counter()
    cnt = _card(oracle["cnt"])
    want = int((cnt > 0).sum())
    if stats["rows"] != want:
        raise AssertionError(f"3n: {stats['rows']} distinct keys, oracle "
                             f"{want}")
    present, _ = _card_dense("3n", res["k"], domain)
    if not torch.equal(present, cnt > 0):
        raise AssertionError("3n: the distinct keys differ from the oracle")
    del res, present, cnt
    torch.cuda.empty_cache()
    rec.update(rows=rows, passes=passes, distinct=want,
               oracle_s=oracle["oracle_s"],
               check_s=time.perf_counter() - t0,
               cold_rows_per_s=rows / stats["total_seconds"])
    report["ooc_unique"] = rec
    log(f"[3n] {want} distinct keys of {rows} exact; {rec['call_s']:.2f} s")


def phase_ooc_sort(report: dict, data, oracle: dict,
                   passes: int = OOC_PASSES, domain: int = OOC_ROWS,
                   profile: bool = False) -> None:
    """Phase 3o: ``chunked_sort`` of the first ``oracle["rows"]`` rows of
    3i's left table by ``k`` ascending: keys never decrease, per-key
    counts equal the numpy bincount and per-key float64 value sums match
    it (rtol 1e-5); no host sort."""
    import torch

    from cylon_tpu_torch import pipeline

    rows = oracle["rows"]
    lk, lv = data[0][:rows], data[1][:rows]
    res, stats, rec = _ooc_call("3o", lambda: pipeline.out_of_core_sort(
        lk, lv, passes))
    if stats["rows"] != rows or len(res["k"]) != rows:
        raise AssertionError(f"3o: {stats['rows']} rows out of {rows}")
    t0 = time.perf_counter()
    k = _card(res["k"]).long()
    if not bool((k[1:] >= k[:-1]).all()):
        raise AssertionError("3o: the keys decrease somewhere")
    if not torch.equal(torch.bincount(k, minlength=domain),
                       _card(oracle["cnt"])):
        raise AssertionError("3o: per-key counts differ from the input's")
    got = torch.bincount(k, weights=_card(res["v"]).double(),
                         minlength=domain)
    sum_err = _card_rtol("3o per-key value sums", got, _card(oracle["sums"]))
    del res, k, got
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    if profile:
        phase_profile(report, "ooc_sort", lambda: pipeline.out_of_core_sort(
            lk, lv, passes))
    rec.update(rows=rows, passes=passes, sum_max_abs_err=sum_err,
               oracle_s=oracle["oracle_s"], check_s=check_s,
               cold_rows_per_s=rows / stats["total_seconds"])
    report["ooc_sort"] = rec
    log(f"[3o] {rows} rows in key order, per-key counts exact, value sums "
        f"max abs err {sum_err:.3g}; {rec['call_s']:.2f} s")


# 3m, 3n and 3o run on the first 2^27 rows of 3i's left table, cut from
# 2^29 for the script's time (PERF.md §4)
OOC_PREFIX_ROWS = 1 << 27
REPARTITION_WORLD = 4
REPARTITION_PASSES = 16


def phase_ooc_repartition(report: dict, data, rows: int = OOC_ROWS,
                          world: int = REPARTITION_WORLD,
                          passes: int = REPARTITION_PASSES,
                          profile: bool = False) -> None:
    """Phase 3p: ``chunked_repartition`` of 3i's two sides as one
    2^30-row ``{k, v}`` frame into ``world`` hash targets in ``passes``
    passes: counts sum to the rows, every target's keys re-hash to it
    under the card's ``hash_partition`` (in chunks), and the bincount of
    all output keys equals the input's.  ``data`` is emptied here: the
    input frame and the output need about 16 GiB of host memory."""
    import numpy as np
    import torch

    from cylon_tpu_torch import column, pipeline
    from cylon_tpu_torch.ops import hash_kernels

    t0 = time.perf_counter()
    keys = np.concatenate([data[0], data[2]])
    vals = np.concatenate([data[1], data[3]])
    data.clear()
    gc.collect()
    concat_s = time.perf_counter() - t0
    n = len(keys)
    parts, stats, rec = _ooc_call("3p", lambda: pipeline.out_of_core_repartition(
        keys, vals, world, passes))
    launches = rec["launches"]
    if launches["hash_partition"] < passes:
        raise AssertionError(f"3p: hash_partition launched "
                             f"{launches['hash_partition']} times in "
                             f"{passes} passes")
    if stats["rows"] != n or sum(stats["per_target"]) != n:
        raise AssertionError(f"3p: {stats['per_target']} rows out of {n}")
    t0 = time.perf_counter()
    chunk = 1 << 26
    left = torch.bincount(_card(keys).long(), minlength=rows)
    for t, p in enumerate(parts):
        k = p["k"]
        if len(k) != stats["per_target"][t] or len(p["v"]) != len(k):
            raise AssertionError(f"3p: target {t} holds {len(k)} rows, "
                                 f"stats say {stats['per_target'][t]}")
        for lo in range(0, len(k), chunk):
            col = column.from_numpy(k[lo:lo + chunk], device="cuda")
            _, tgt = hash_kernels.hash_partition([col], world)
            if not bool((tgt[:min(chunk, len(k) - lo)] == t).all()):
                raise AssertionError(f"3p: a key of target {t} hashes "
                                     f"elsewhere")
        left -= torch.bincount(_card(k).long(), minlength=rows)
    if bool(left.any()):
        raise AssertionError("3p: the output keys' bincount differs from "
                             "the input's")
    check_s = time.perf_counter() - t0
    del parts, left
    gc.collect()
    torch.cuda.empty_cache()
    if profile:
        phase_profile(report, "ooc_repartition",
                      lambda: pipeline.out_of_core_repartition(
                          keys, vals, world, passes))
    del keys, vals
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(rows=n, world=world, passes=passes, check_s=check_s,
               concat_s=concat_s,
               cold_rows_per_s=n / stats["total_seconds"],
               steady_rows_per_s=n / stats["run_seconds"])
    report["ooc_repartition"] = rec
    log(f"[3p] {n} rows into {world} targets {stats['per_target']}, every "
        f"key re-hashes to its target, key multiset exact; cold "
        f"{rec['cold_rows_per_s']:.6g} rows/s, {rec['call_s']:.2f} s")


DIST_OOC_ROWS = 1 << 26  # cut from 2^28 for the script's time (PERF.md §4)
DIST_OOC_PASSES = 8


def phase_ooc_distributed(report: dict, rows: int = DIST_OOC_ROWS,
                          passes: int = DIST_OOC_PASSES,
                          profile: bool = False) -> None:
    """Phase 3q: ``chunked_distributed_join_groupby`` of 2^26 rows per
    side over SHARDS in-process shards on the one card, in 8 passes,
    against the numpy ``bincount`` oracle; the hash kernel must launch in
    every pass.  4 shards on one card, not a multi-card number."""
    import numpy as np
    import torch

    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline
    from cylon_tpu_torch import exec as exec_mod
    from cylon_tpu_torch.ops import hash_kernels

    t0 = time.perf_counter()
    data = pipeline.make_data(rows, pipeline.SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = _oracle(data, rows)
    oracle_s = time.perf_counter() - t0
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                  world_size=SHARDS))
    per_pass = []
    exec_mod.PASS_PROGRESS_HOOK = (
        lambda done, n, total, secs: per_pass.append(
            hash_kernels.LAUNCHES["hash_partition"]))
    try:
        res, stats, rec = _ooc_call(
            "3q", lambda: pipeline.out_of_core_distributed_join_groupby(
                data, passes, ctx))
    finally:
        exec_mod.PASS_PROGRESS_HOOK = None
    if profile:
        phase_profile(report, "ooc_distributed",
                      lambda: pipeline.out_of_core_distributed_join_groupby(
                          data, passes, ctx))
    del data
    steps = np.diff([0] + per_pass)
    if len(steps) != stats["passes"] or not (steps > 0).all():
        raise AssertionError(f"3q: hash_partition launches per pass "
                             f"{steps.tolist()}")
    if stats["groups"] != oracle["groups"] or stats["world"] != SHARDS:
        raise AssertionError(f"3q: {stats['groups']} groups, oracle "
                             f"{oracle['groups']}")
    t0 = time.perf_counter()
    present, (g_sum, g_mean) = _card_dense("3q", res["l_k"], rows,
                                           res["sum_a"], res["mean_b"])
    del res
    keys = _card(oracle["keys"]).long()
    want = torch.zeros(rows, dtype=torch.bool, device="cuda")
    want[keys] = True
    if not torch.equal(present, want):
        raise AssertionError("3q: the group keys differ from the oracle")
    sum_err = _card_rtol("3q SUM", g_sum[keys], _card(oracle["sum"]))
    mean_err = _card_rtol("3q MEAN", g_mean[keys], _card(oracle["mean"]))
    check_s = time.perf_counter() - t0
    del present, want, g_sum, g_mean, keys, oracle
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(rows_per_side=rows, passes=passes, shards=SHARDS,
               generate_s=gen_s, oracle_s=oracle_s, check_s=check_s,
               hash_launches_per_pass=steps.tolist(),
               sum_max_abs_err=sum_err, mean_max_abs_err=mean_err,
               cold_rows_per_s=2 * rows / stats["total_seconds"],
               steady_rows_per_s=2 * rows / stats["run_seconds"])
    report["ooc_distributed"] = rec
    log(f"[3q] {stats['groups']} groups exact; SUM max abs err "
        f"{sum_err:.3g}, MEAN {mean_err:.3g}; hash launches per pass "
        f"{steps.tolist()}; cold {rec['cold_rows_per_s']:.6g} rows/s "
        f"({SHARDS} shards on one card), {rec['call_s']:.2f} s")


def _row_order(cols):
    """The order sorting rows of equal-length CUDA int32/float32 columns
    by all their bits, by stable sorts from the last column to the
    first."""
    import torch

    order = None
    for c in reversed(cols):
        bits = c.view(torch.int32).to(torch.int64) if c.dtype == \
            torch.float32 else c.to(torch.int64)
        key = bits if order is None else bits[order]
        o = torch.sort(key, stable=True).indices
        order = o if order is None else order[o]
    return order


def _same_join_rows(label: str, got: dict, want: dict) -> None:
    """The same multiset of (l_k, lv, r_k, rv) rows, compared on the card
    after sorting both by every column."""
    import torch

    names = ["l_k", "lv", "r_k", "rv"]
    if len(got["l_k"]) != len(want["l_k"]):
        raise AssertionError(f"{label}: {len(got['l_k'])} rows, uncapped "
                             f"{len(want['l_k'])}")
    sides = []
    for frame in (got, want):
        cols = [torch.from_numpy(frame[n]).cuda() for n in names]
        order = _row_order(cols)
        sides.append([c[order] for c in cols])
    for n, a, b in zip(names, *sides):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: column {n} differs from the "
                                 f"uncapped run's")


def _capped(fraction: float, fn):
    """``fn()`` with the caching allocator capped at ``fraction`` of the
    card, the cap lifted afterwards even when ``fn`` fails; (result,
    peak reserved bytes)."""
    import torch

    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(fraction)
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_reserved()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()


def _uncapped_peak(fn):
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_reserved()


def phase_oneshot_fallback(report: dict, rows: int = ROWS) -> None:
    """Phase 3r: the one-shot ``Table.join`` and hash ``Table.groupby``
    fall back to the chunked engine under a real allocator OOM.  On phase
    3's 2^26-row-per-side tables (one shard on the card), each one-shot
    op and its 4-pass chunked counterpart run uncapped; then the caching
    allocator is capped between the two peaks, the one-shot op must fall
    back (a ``table.oneshot_fallback`` instant) and equal the uncapped
    result."""
    import numpy as np
    import torch

    from cylon_tpu_torch import CylonContext, Table
    from cylon_tpu_torch import exec as exec_mod
    from cylon_tpu_torch import pipeline
    from cylon_tpu_torch.obs import spans as obs_spans

    lk, lv, rk, rv = pipeline.make_data(rows, pipeline.SEED)
    ctx = CylonContext.Init("cuda")
    left = Table.from_numpy(["k", "lv"], [lk, lv], ctx=ctx)
    right = Table.from_numpy(["k", "rv"], [rk, rv], ctx=ctx)
    del lk, lv, rk, rv
    total = torch.cuda.get_device_properties(0).total_memory
    agg = {"lv": ["sum", "count"]}
    cases = {
        "join": (lambda: left.join(right, on="k").to_numpy(),
                 lambda: exec_mod.chunked_join(left, right, on="k", passes=4,
                                               ctx=ctx)[0]),
        "groupby": (lambda: left.groupby("k", agg).to_numpy(),
                    lambda: exec_mod.chunked_groupby(left, "k", agg,
                                                     passes=4, ctx=ctx)[0]),
    }
    out = {}
    for name, (oneshot, chunked) in cases.items():
        want, one_peak = _uncapped_peak(oneshot)
        _, chunk_peak = _uncapped_peak(chunked)
        cap = (one_peak + chunk_peak) // 2
        if not chunk_peak < cap < one_peak:
            raise AssertionError(f"3r {name}: no room between the peaks: "
                                 f"{chunk_peak} < {cap} < {one_peak}")
        before = obs_spans.aggregate_report().get(
            "table.oneshot_fallback", (0.0, 0))[1]
        _reset_launches()
        t0 = time.perf_counter()
        got, capped_peak = _capped(cap / total, oneshot)
        call_s = time.perf_counter() - t0
        launches = _launch_counts()
        fell_back = obs_spans.aggregate_report().get(
            "table.oneshot_fallback", (0.0, 0))[1] - before
        if fell_back != 1:
            raise AssertionError(f"3r {name}: {fell_back} fallbacks under "
                                 f"the cap")
        if name == "join":
            _same_join_rows("3r join", got, want)
            detail = {"rows": len(got["l_k"])}
        else:
            g_keys, (g_cnt, g_sum) = _card_dense(
                "3r groupby", got["k"], rows, got["count_lv"],
                got["sum_lv"])
            w_keys, (w_cnt, w_sum) = _card_dense(
                "3r groupby", want["k"], rows, want["count_lv"],
                want["sum_lv"])
            if not torch.equal(g_keys, w_keys) \
                    or not torch.equal(g_cnt, w_cnt):
                raise AssertionError("3r groupby: keys or counts differ "
                                     "from the uncapped run's")
            detail = {"groups": len(got["k"]), "sum_max_abs_err":
                      _card_rtol("3r groupby SUM", g_sum[w_keys],
                                 w_sum[w_keys])}
            del g_keys, g_cnt, g_sum, w_keys, w_cnt, w_sum
        del got, want
        gc.collect()
        out[name] = {"oneshot_peak_reserved_bytes": one_peak,
                     "chunked_peak_reserved_bytes": chunk_peak,
                     "cap_bytes": cap, "fraction": cap / total,
                     "capped_peak_reserved_bytes": capped_peak,
                     "fallbacks": fell_back, "capped_call_s": call_s,
                     "launches": launches, "host": _host_memory(),
                     **detail}
        log(f"[3r] {name}: {json.dumps(out[name])}")
    del left, right
    gc.collect()
    torch.cuda.empty_cache()
    report["oneshot_fallback"] = out


# -- phase 3s: the front door -------------------------------------------------

FRONT_SF = 1  # BASELINE config 2's scale: TPC-H SF-1
ORDERS_ROWS = 1_500_000  # TPC-H orders rows at SF-1
LOC_KEYS = 1000


def _front_door_data():
    """Q1's lineitem columns at SF-1 (``pipeline.lineitem``) with an
    ``l_orderkey`` from its own generator, and the orders columns; the
    flags as S1 arrays, so ``Table.from_numpy`` takes them as strings."""
    import numpy as np

    from cylon_tpu_torch import pipeline

    data = pipeline.lineitem(FRONT_SF, seed=0)
    n = len(data["l_shipdate"])
    arrays = {k: v for k, v in data.items()
              if k not in ("l_returnflag", "l_linestatus")}
    for k in ("l_returnflag", "l_linestatus"):
        arrays[k] = data[k][0].reshape(n).view("S1")
    arrays["l_orderkey"] = np.random.default_rng(1).integers(
        0, ORDERS_ROWS, n).astype(np.int64)
    orders = {"o_orderkey": np.arange(ORDERS_ROWS, dtype=np.int64),
              "o_orderdate": np.random.default_rng(2).integers(
                  pipeline.DATE_LO, pipeline.DATE_HI,
                  ORDERS_ROWS).astype(np.int32)}
    return data, arrays, orders


def _same_rows(label: str, got, want) -> None:
    """Two tables of one shard layout hold the same live rows, shard for
    shard, checked on the card: integers as int64 values, floats as the
    float64 of the written values, strings byte for byte (the narrower
    byte matrix padded with zeros), and no nulls."""
    import torch

    if list(got.names) != list(want.names):
        raise AssertionError(f"{label}: columns {got.names} != {want.names}")
    for s, (gc_, wc, gn, wn) in enumerate(zip(got.shards, want.shards,
                                              got.counts, want.counts)):
        n = int(gn)
        if n != int(wn):
            raise AssertionError(f"{label} shard {s}: {n} rows, wrote "
                                 f"{int(wn)}")
        for name, g, w in zip(got.names, gc_, wc):
            where = f"{label} shard {s} column {name}"
            if not (bool(g.validity[:n].all()) and bool(w.validity[:n].all())):
                raise AssertionError(f"{where}: nulls")
            if w.is_string:
                width = max(g.string_width, w.string_width)
                gd = torch.nn.functional.pad(g.data[:n],
                                             (0, width - g.string_width))
                wd = torch.nn.functional.pad(w.data[:n],
                                             (0, width - w.string_width))
                same = torch.equal(gd, wd) and torch.equal(
                    g.lengths[:n], w.lengths[:n])
            else:
                same = torch.equal(g.data[:n], w.data[:n].to(g.data.dtype))
            if not same:
                raise AssertionError(f"{where}: values differ")


def _csv_bytes(paths) -> int:
    return sum(os.path.getsize(p) for p in paths)


def _step(report: dict, name: str, fn):
    """Run ``fn`` with the launch counters zeroed just before and read
    just after, and the peak device memory reset; record its seconds,
    launches and peak, and return its result."""
    import torch

    from cylon_tpu_torch import io

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    report[name] = {"s": time.perf_counter() - t0,
                    "launches": _launch_counts(),
                    "peak_device_bytes": torch.cuda.max_memory_allocated(),
                    "reader_counts": io.reader_counts()}
    return out


def phase_front_door(report: dict) -> None:
    """Phase 3s: the Quickstart's path at TPC-H SF-1, through the port's
    front door, in a temporary directory: (a) ``to_csv`` of lineitem per
    shard and of orders to one file (the orders file read back by pyarrow
    as an independent check); (b) ``from_csv`` of both onto 4 shards, each
    shard equal to the rows written from it; (c) Q1 through ``DataFrame``
    against the numpy oracle; (d) the distributed orders x lineitem
    ``merge`` (6,000,000 rows, the ``o_orderdate`` checksum); (e) a
    per-shard Parquet round trip of the Q1-filtered table; (f)
    ``set_index`` / ``loc`` / ``iloc`` on a one-shard orders table.  The
    native reader and writer must serve every CSV; the hash kernel must
    launch in (d) and both scan kernels in (c)."""
    import tempfile

    import numpy as np
    import pyarrow.csv as pacsv
    import torch

    from cylon_tpu_torch import (CylonContext, DataFrame, MeshConfig, Table,
                                 io, native, pipeline)

    if not native.available():
        raise AssertionError(f"3s: the native library did not load: "
                             f"{native.load_error()}")
    t0 = time.perf_counter()
    data, arrays, orders = _front_door_data()
    oracle = _q1_oracle(data)
    rows = len(arrays["l_orderkey"])
    ctx = CylonContext.InitDistributed(MeshConfig(world_size=SHARDS))
    li_t = Table.from_numpy(list(arrays), list(arrays.values()), ctx=ctx)
    or_t = Table.from_numpy(list(orders), list(orders.values()), ctx=ctx)
    torch.cuda.synchronize()
    out: dict = {"rows": rows, "orders_rows": ORDERS_ROWS,
                 "setup_s": time.perf_counter() - t0}
    log(f"[3s] TPC-H SF-{FRONT_SF}: {rows} lineitem rows, {ORDERS_ROWS} "
        f"orders, {SHARDS} shards; data, oracle and tables in "
        f"{out['setup_s']:.1f} s")
    steps: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        li_paths = [os.path.join(tmp, f"lineitem_{s}.csv")
                    for s in range(SHARDS)]
        or_path = os.path.join(tmp, "orders.csv")
        io.reset_reader_counts()

        # (a) write
        _step(steps, "a_write", lambda: (
            li_t.to_csv(os.path.join(tmp, "lineitem_{shard}.csv"),
                        per_shard=True),
            or_t.to_csv(or_path)))
        nbytes = _csv_bytes(li_paths + [or_path])
        steps["a_write"].update(bytes=nbytes)
        got = pacsv.read_csv(or_path)
        for name, want in orders.items():
            if not np.array_equal(got.column(name).to_numpy(), want):
                raise AssertionError(f"3s (a) pyarrow reads {name} back "
                                     "different")
        first = pacsv.read_csv(li_paths[0])
        n0 = int(li_t.counts[0])
        for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
            back = first.column(name).to_numpy()
            if not np.array_equal(back, arrays[name][:n0].astype(np.float64)):
                raise AssertionError(f"3s (a) {name} does not read back "
                                     "exactly (%.17g)")
        counts = io.reader_counts()
        if counts["csv_write_native"] != SHARDS + 1 \
                or counts["csv_write_pandas"]:
            raise AssertionError(f"3s (a) writers: {counts}")

        # (b) read
        li, od = _step(steps, "b_read", lambda: (
            Table.from_csv(li_paths, ctx=ctx),
            Table.from_csv(or_path, ctx=ctx)))
        steps["b_read"].update(bytes=nbytes)
        counts = io.reader_counts()
        if counts["csv_read_native"] != SHARDS + 1 or counts["csv_read_arrow"]:
            raise AssertionError(f"3s (b) readers: {counts}")
        for t in (li, od):
            for c in t.shards[0]:
                if c.dtype.numpy_dtype() not in (np.int64, np.float64) \
                        and not c.is_string:
                    raise AssertionError(f"3s (b) read type {c.dtype}")
        _same_rows("3s (b) lineitem", li, li_t)
        _same_rows("3s (b) orders", od, or_t)
        del li_t

        # (c) Q1 through DataFrame
        def q1():
            df = DataFrame(li)
            f = df[df["l_shipdate"] <= pipeline.Q1_CUTOFF]
            f["disc_price"] = (f["l_extendedprice"]
                               * (f["l_discount"] * -1.0 + 1.0))
            f["charge"] = f["disc_price"] * (f["l_tax"] + 1.0)
            return f, f.groupby(["l_returnflag", "l_linestatus"],
                                pipeline.Q1_AGGS).to_pandas()

        filtered, q1_pdf = _step(steps, "c_q1", q1)
        err = _check_q1("3s (c)", {c: q1_pdf[c].to_numpy()
                                   for c in q1_pdf.columns}, oracle)
        steps["c_q1"].update(max_rel_err=err, groups=len(q1_pdf))

        # (d) the CSV join, distributed
        merged = _step(steps, "d_merge", lambda: DataFrame(od).merge(
            DataFrame(li), left_on="o_orderkey",
            right_on="l_orderkey").to_table())
        want_sum = int(orders["o_orderdate"][arrays["l_orderkey"]]
                       .astype(np.int64).sum())
        got_sum = int(merged.sum("o_orderdate"))
        if merged.row_count != rows or got_sum != want_sum:
            raise AssertionError(f"3s (d) merge: {merged.row_count} rows, "
                                 f"checksum {got_sum}; want {rows}, "
                                 f"{want_sum}")
        steps["d_merge"].update(rows=merged.row_count, checksum=got_sum)
        del merged

        # (e) Parquet round trip of the Q1-filtered table
        ft = filtered.to_table()
        pq_paths = [os.path.join(tmp, f"q1_{s}.parquet")
                    for s in range(SHARDS)]
        back = _step(steps, "e_parquet", lambda: (
            ft.to_parquet(os.path.join(tmp, "q1_{shard}.parquet"),
                          per_shard=True),
            Table.from_parquet(pq_paths, ctx=ctx))[1])
        _same_rows("3s (e) parquet", back, ft)
        steps["e_parquet"].update(rows=ft.row_count,
                                  bytes=_csv_bytes(pq_paths))
        del back, ft, filtered

        # (f) row access on a one-shard orders table
        keys = np.random.default_rng(3).integers(0, ORDERS_ROWS, LOC_KEYS)
        lo, hi = 1000, 1999
        a, b = ORDERS_ROWS // 2, ORDERS_ROWS // 2 + 1000

        def rows_of():
            one = Table.from_csv(or_path, ctx=CylonContext.Init())
            one.set_index("o_orderkey")
            return one.loc[list(keys)], one.loc[lo:hi], one.iloc[a:b]

        by_key, by_range, by_pos = _step(steps, "f_rows", rows_of)
        for label, t, want_keys in (("loc[keys]", by_key, keys),
                                    ("loc[lo:hi]", by_range,
                                     np.arange(lo, hi + 1)),
                                    ("iloc[a:b]", by_pos, np.arange(a, b))):
            got = t.to_numpy()
            if not (np.array_equal(got["o_orderkey"], want_keys)
                    and np.array_equal(got["o_orderdate"],
                                       orders["o_orderdate"][want_keys])):
                raise AssertionError(f"3s (f) {label} differs from numpy")
        if io.reader_counts()["csv_read_native"] != SHARDS + 2:
            raise AssertionError(f"3s (f) readers: {io.reader_counts()}")
        del li, od, by_key, by_range, by_pos
    for name, st in steps.items():
        if "bytes" in st and name != "e_parquet":
            st["mb_per_s"] = st["bytes"] / st["s"] / 1e6
            st["rows_per_s"] = (rows + ORDERS_ROWS) / st["s"]
        log(f"[3s] {name}: {json.dumps(st)}")
    for step, kernels in (("c_q1", ("scan_1d", "segmented_scan")),
                          ("d_merge", ("hash_partition",))):
        for k in kernels:
            if not steps[step]["launches"].get(k):
                raise AssertionError(f"3s {step}: {k} never launched")
    out.update(steps=steps, reader_counts=io.reader_counts(),
               wall_s=time.perf_counter() - t0)
    log(f"[3s] passed in {out['wall_s']:.1f} s: the native reader and "
        f"writer served every CSV, every shard read back equal, Q1 groups "
        f"and counts exact (max rel err {steps['c_q1']['max_rel_err']:.3g}),"
        f" the merge gave {rows} rows with the oracle's checksum")
    gc.collect()
    torch.cuda.empty_cache()
    report["front_door"] = out


# -- phase 4 ------------------------------------------------------------------

# -- phase 3v: the out-of-core engine and DataFrame through a group -----------

GROUP_OOC_ROWS = 1 << 24  # a quarter of 3q's 2^26 per side, for the time
GROUP_OOC_PASSES = 8


def _same_frames(label: str, got: dict, want: dict) -> None:
    """Two host frames hold the same columns, bit for bit."""
    import numpy as np

    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} != "
                             f"{list(want)}")
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: column {name} differs")
        if g.dtype == object:  # strings and None nulls: by value
            if g.tolist() != w.tolist():
                raise AssertionError(f"{label}: column {name} differs")
        elif not np.array_equal(np.ascontiguousarray(g).view(np.uint8),
                                np.ascontiguousarray(w).view(np.uint8)):
            raise AssertionError(f"{label}: column {name} differs")


def phase_ooc_group(report: dict, profile: bool = False) -> None:
    """Phase 3v: the out-of-core engine and ``DataFrame`` on a context over
    an NCCL group of one rank holding SHARDS shards (NCCL refuses two
    ranks on one card).  ``pipeline.out_of_core_distributed_join_groupby``
    of 2^24 rows per side in 8 passes through the group (every pass's
    tables built and gathered through its collectives, the pass plan
    agreed by an all-gather of its digest), with the launch counters
    zeroed just before and read just after (all three kernels must
    launch); its frames must equal the in-process mesh engine's on the
    same data bit for bit, and the numpy oracle.  Then a ``DataFrame``
    merge -> group-by through the same group against the oracle.  Ends
    with ``Finalize()``."""
    import numpy as np
    import torch

    from cylon_tpu_torch import CylonContext, DataFrame, MeshConfig, pipeline

    t_phase = time.perf_counter()
    rows, passes = GROUP_OOC_ROWS, GROUP_OOC_PASSES
    data = pipeline.make_data(rows, pipeline.SEED)
    oracle = _oracle(data, rows)
    mesh = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                   world_size=SHARDS))
    want, want_stats = pipeline.out_of_core_distributed_join_groupby(
        data, passes, mesh)
    group = CylonContext.InitDistributed(MeshConfig(world_size=SHARDS,
                                                    num_processes=1))
    try:
        if group.group.backend != "nccl":
            raise AssertionError(f"3v: {group!r} is not an NCCL rank")
        res, stats, rec = _ooc_call(
            "3v", lambda: pipeline.out_of_core_distributed_join_groupby(
                data, passes, group))
        launches = rec["launches"]
        if min(launches.values()) < 1:
            raise AssertionError(f"3v did not launch every kernel: "
                                 f"{launches}")
        _same_frames("3v engine over the group against the mesh engine",
                     res, want)
        for k in ("passes", "groups", "world", "shard_cap", "mode"):
            if stats[k] != want_stats[k]:
                raise AssertionError(f"3v stats {k}: {stats[k]} != "
                                     f"{want_stats[k]}")
        order = np.argsort(res["l_k"], kind="stable")
        sum_err, mean_err = _check_groups(
            oracle, res["l_k"][order], res["sum_a"][order],
            res["mean_b"][order], "3v engine")
        del want, res
        if profile:
            phase_profile(
                report, "ooc_group",
                lambda: pipeline.out_of_core_distributed_join_groupby(
                    data, passes, group))
        lk, lv, rk, rv = data
        t0 = time.perf_counter()
        left = DataFrame({"k": lk, "a": lv}, ctx=group)
        right = DataFrame({"k": rk, "b": rv}, ctx=group)
        build_s = time.perf_counter() - t0
        _reset_launches()
        t0 = time.perf_counter()
        out = left.merge(right, on="k").groupby(
            "l_k", {"a": ["sum"], "b": ["mean"]}).to_pandas()
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        frame_launches = _launch_counts()
        out = out.sort_values("l_k")
        frame_errs = _check_groups(oracle, out["l_k"].to_numpy(),
                                   out["sum_a"].to_numpy(),
                                   out["mean_b"].to_numpy(), "3v DataFrame")
        if min(frame_launches.values()) < 1:
            raise AssertionError(f"3v DataFrame did not launch every "
                                 f"kernel: {frame_launches}")
        del left, right, out
        group.Barrier()
    finally:
        group.Finalize()
    del data
    rec.update(rows_per_side=rows, passes=passes, shards=SHARDS,
               backend="nccl", ranks=1, mesh_seconds=want_stats[
                   "total_seconds"], sum_max_abs_err=sum_err,
               mean_max_abs_err=mean_err,
               dataframe={"build_s": build_s, "merge_groupby_s": frame_s,
                          "launches": frame_launches,
                          "sum_max_abs_err": frame_errs[0],
                          "mean_max_abs_err": frame_errs[1]},
               phase_seconds=time.perf_counter() - t_phase)
    report["ooc_group"] = rec
    log(f"[3v] engine over one NCCL rank ({SHARDS} shards, {rows} rows per "
        f"side, {passes} passes): {stats['total_seconds']:.2f} s, "
        f"plan_seconds {stats['plan_seconds']:.2f}, launches {launches}; "
        f"frames equal to the mesh engine's bit for bit (mesh "
        f"{want_stats['total_seconds']:.2f} s); {stats['groups']} groups "
        f"exact, SUM max abs err {sum_err:.3g}, MEAN {mean_err:.3g}; "
        f"DataFrame merge -> group-by {frame_s:.2f} s (build {build_s:.2f} "
        f"s), launches {frame_launches}; phase {rec['phase_seconds']:.1f} s")


# -- phase 3w: TPC-H Q10 and Q5 through the planner ---------------------------

TPCH_SF = 1.0  # cut from BASELINE config 4's SF-100 for the time (PERF.md §4)


def _tpch_data(sf: float) -> dict:
    """Q10's and Q5's tables as ``cylon_tpu_torch/examples/tpch_data.py``
    draws them for Q5 (``tpch_q5.draw``, seed 0)."""
    from cylon_tpu_torch.examples import tpch_q5

    return tpch_q5.draw(sf)


def _tpch_oracles(raw: dict) -> dict:
    """pandas float64 oracles of Q10 and Q5 (the examples' own)."""
    import pandas as pd

    from cylon_tpu_torch import pipeline

    frames = {k: pd.DataFrame(v) for k, v in raw.items()}
    lo, hi = pipeline.Q10_DATES
    o = frames["o"][(frames["o"].o_orderdate >= lo)
                    & (frames["o"].o_orderdate < hi)]
    li = frames["l"].drop(columns="l_suppkey")
    li = li[li.l_returnflag == "R"]
    j = (o.merge(li, left_on="o_orderkey", right_on="l_orderkey")
         .merge(frames["c"], left_on="o_custkey", right_on="c_custkey")
         .merge(frames["n"], left_on="c_nationkey", right_on="n_nationkey"))
    j["revenue"] = j.l_extendedprice.astype("float64") * (
        1 - j.l_discount.astype("float64"))
    q10 = (j.groupby(["c_custkey", "c_nationkey", "n_name"]).revenue.sum()
           .reset_index().sort_values(["revenue", "c_custkey"],
                                      ascending=[False, True])
           .head(pipeline.Q10_TOP).reset_index(drop=True))
    lo, hi = pipeline.Q5_DATES
    o = frames["o"][(frames["o"].o_orderdate >= lo)
                    & (frames["o"].o_orderdate < hi)]
    j = (frames["c"].merge(o, left_on="c_custkey", right_on="o_custkey")
         .merge(frames["l"], left_on="o_orderkey", right_on="l_orderkey")
         .merge(frames["s"], left_on="l_suppkey", right_on="s_suppkey"))
    j = j[j.c_nationkey == j.s_nationkey]
    j = (j.merge(frames["n"], left_on="c_nationkey", right_on="n_nationkey")
         .merge(frames["r"], left_on="n_regionkey", right_on="r_regionkey"))
    j = j[j.r_regionkey == pipeline.Q5_REGION]
    j["revenue"] = j.l_extendedprice.astype("float64") * (
        1 - j.l_discount.astype("float64"))
    q5 = (j.groupby("n_name").revenue.sum().reset_index()
          .sort_values(["revenue", "n_name"], ascending=[False, True])
          .reset_index(drop=True))
    return {"q10": q10, "q5": q5}


def _check_query(label: str, got, want, keys) -> float:
    """A query's frame against its pandas oracle: the key columns exact,
    in order; revenue within F32_SUM_RTOL of float64."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, oracle "
                             f"{len(want)}")
    for k in keys:
        if not np.array_equal(got[k].to_numpy(), want[k].to_numpy()):
            raise AssertionError(f"{label}: {k} differs from the oracle")
    g = got["sum_revenue"].to_numpy().astype(np.float64)
    w = want["revenue"].to_numpy()
    err = np.abs(g - w)
    if not (err <= F32_SUM_RTOL * np.abs(w)).all():
        raise AssertionError(f"{label}: revenue outside rtol "
                             f"{F32_SUM_RTOL} of the oracle")
    return float(err.max(initial=0.0))


def phase_planner(report: dict, profile: bool = False):
    """Phase 3w: TPC-H Q10 (``pipeline.tpch_q10_plan``) and Q5
    (``pipeline.tpch_q5_plan``) at SF-1 on SHARDS shards of the in-process
    mesh, each planned and eager (``CYLON_TPU_PLAN=0``): the first run of
    each with the launch counters and the metrics zeroed just before and
    read just after (all three kernels must launch, and the planned run
    must elide at least one shuffle), then best-of-3 ms; planned equal to
    eager bit for bit, both equal to the pandas oracle; exchanges and
    bytes sent planned against eager; peak device memory.  Returns the
    Q10 plan (its tables stay on the card) for phases 3x and 3y, and for
    3y its pandas oracle and the host columns of lineitem and orders its
    stream reads, and for 3aa the host tables and the Q5 oracle."""
    import numpy as np
    import torch

    from cylon_tpu_torch import (CylonContext, MeshConfig, Table, config,
                                 pipeline)
    from cylon_tpu_torch.obs import metrics

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    raw = _tpch_data(TPCH_SF)
    oracles = _tpch_oracles(raw)
    prep_s = time.perf_counter() - t0
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                  world_size=SHARDS))
    t0 = time.perf_counter()
    tables = {k: Table.from_numpy(list(v), list(v.values()), ctx=ctx)
              for k, v in raw.items()}
    # Q10 joins lineitem on l_orderkey only (examples/tpch_q10.py drops
    # l_suppkey); a projection, not a second upload of 6M string rows
    q10_line = tables["l"].project([n for n in tables["l"].names
                                    if n != "l_suppkey"])
    plans = {
        "q10": pipeline.tpch_q10_plan(tables["c"], tables["o"], q10_line,
                                      tables["n"]),
        "q5": pipeline.tpch_q5_plan(*(tables[k] for k in "colsnr"))}
    keys = {"q10": ("c_custkey", "c_nationkey", "n_name"),
            "q5": ("n_name",)}
    upload_s = time.perf_counter() - t0
    out: dict = {"sf": TPCH_SF, "shards": SHARDS, "prep_s": prep_s,
                 "upload_s": upload_s,
                 "rows": {k: len(next(iter(v.values())))
                          for k, v in raw.items()}}
    serve_inputs = {
        "q10_oracle": oracles["q10"],
        "lineitem": {c: raw["l"][c] for c in SERVE_STREAM_COLUMNS},
        "orders": {c: raw["o"][c] for c in SERVE_ORDERS_COLUMNS},
        "raw": raw, "q5_oracle": oracles["q5"]}
    del raw
    for q, plan in plans.items():
        rec: dict = {}
        frames = {}
        for arm, knob in (("planned", None), ("eager", "0")):
            with config.knob_env(CYLON_TPU_PLAN=knob):
                torch.cuda.synchronize()
                _reset_launches()
                metrics.reset()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                t = plan.execute()  # the first run of this lowering
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                launches = _launch_counts()
                c = metrics.snapshot()["counters"]
                peak = torch.cuda.max_memory_allocated()
                frames[arm] = t.to_pandas().reset_index(drop=True)
                timed = _time_op(plan.execute, 0, runs=3)
            rec[arm] = {
                "first_s": first_s, "best_ms": timed["best_ms"],
                "times_ms": timed["times_ms"], "launches": launches,
                "shuffles_elided": c.get("plan.shuffles_elided", 0),
                "exchanges": c.get("shuffle.exchanges", 0),
                "bytes_sent": c.get("shuffle.bytes_sent", 0),
                "collective_launches": c.get("shuffle.collective_launches",
                                             0),
                "peak_device_bytes": peak}
            if min(launches.values()) < 1:
                raise AssertionError(f"3w {q} {arm} did not launch every "
                                     f"kernel: {launches}")
        if rec["planned"]["shuffles_elided"] < 1:
            raise AssertionError(f"3w {q}: no shuffle elided")
        for col in frames["planned"].columns:
            a = frames["planned"][col].to_numpy()
            b = frames["eager"][col].to_numpy()
            if not np.array_equal(a, b):
                raise AssertionError(f"3w {q}: planned and eager differ in "
                                     f"{col}")
        rec["revenue_max_abs_err"] = _check_query(
            f"3w {q}", frames["planned"], oracles[q], keys[q])
        rec["explain"] = plan.explain()
        if profile:
            phase_profile(report, f"planner_{q}", plan.execute)
        out[q] = rec
        p, e = rec["planned"], rec["eager"]
        log(f"[3w] {q} SF-{TPCH_SF:g}: planned best-of-3 {p['best_ms']:.2f} "
            f"ms (first {p['first_s'] * 1e3:.2f} ms), eager "
            f"{e['best_ms']:.2f} ms (first {e['first_s'] * 1e3:.2f} ms); "
            f"shuffles elided {p['shuffles_elided']}; exchanges "
            f"{p['exchanges']} vs {e['exchanges']}, bytes sent "
            f"{p['bytes_sent']} vs {e['bytes_sent']}; launches planned "
            f"{p['launches']} eager {e['launches']}; peak "
            f"{p['peak_device_bytes'] / 2**30:.2f} / "
            f"{e['peak_device_bytes'] / 2**30:.2f} GiB; bit-identical, "
            f"revenue max abs err {rec['revenue_max_abs_err']:.3g}")
    q10 = plans["q10"]  # 3x replays it from the journal, 3y serves it
    del plans, tables, q10_line
    out["phase_seconds"] = time.perf_counter() - t_phase
    report["planner"] = out
    log(f"[3w] phase {out['phase_seconds']:.1f} s (data and pandas oracles "
        f"{prep_s:.1f} s, upload {upload_s:.1f} s)")
    return q10, serve_inputs


# -- phase 3x: the run journal ------------------------------------------------

# 3v's data halved (2^24 rows per side ran the phase in 64.1 s against
# its 60 s budget on one H100; PERF.md §4), in 8 passes on one card
DURABLE_ROWS = GROUP_OOC_ROWS // 2
DURABLE_PASSES = 8
DURABLE_KILL_PLAN = "journal_commit@5=killhard"  # dies committing pass 5
DURABLE_CHILD_TIMEOUT_S = 300


def _durable_inputs():
    """3v's bench data at DURABLE_ROWS per side
    (``pipeline.make_data(DURABLE_ROWS)``, seed 12345) as the engine's two
    host frames."""
    from cylon_tpu_torch import pipeline

    lk, lv, rk, rv = pipeline.make_data(DURABLE_ROWS, pipeline.SEED)
    return {"k": lk, "a": lv}, {"k": rk, "b": rv}


def _durable_run(left, right):
    """The single-card engine: inner join on k -> SUM(a), MEAN(b) by l_k
    in DURABLE_PASSES passes, journaled when CYLON_TPU_DURABLE_DIR is
    set."""
    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.exec import chunked_join_groupby_tables

    return chunked_join_groupby_tables(
        left, right, on="k", group_by="l_k",
        agg={"a": ["sum"], "b": ["mean"]}, passes=DURABLE_PASSES,
        ctx=CylonContext.Init("cuda"))


def _timed_durable(label: str, fn):
    """(result, stats, seconds, launches, durable.* counters, span
    seconds) of one synchronised call, counters and metrics zeroed just
    before."""
    import torch

    from cylon_tpu_torch.obs import metrics
    from cylon_tpu_torch.obs import spans

    torch.cuda.synchronize()
    _reset_launches()
    metrics.reset()
    spans.reset_aggregates()
    t0 = time.perf_counter()
    res, stats = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counters = {k: v for k, v in metrics.snapshot()["counters"].items()
                if k.startswith(("durable.", "plan.", "exec."))}
    agg = {k: v for k, v in spans.aggregate_report().items()
           if k in ("exec.pass", "durable.spill", "durable.load",
                    "durable.fingerprint", "durable.read_repair")}
    rec = {"seconds": secs, "launches": _launch_counts(),
           "counters": counters,
           "spans_s": {k: v[0] for k, v in agg.items()},
           "passes_skipped": stats.get("passes_skipped"),
           "parts_run": stats.get("parts_run"),
           "plan_seconds": stats.get("plan_seconds")}
    log(f"[3x] {label}: {json.dumps(rec, default=str)}")
    return res, stats, rec


def durable_worker(root: str, out: str) -> int:
    """``chip_smoke.py --durable-worker ROOT OUT.npz``: one journaled run
    of 3x's engine call into ROOT in its own process, under whatever
    ``CYLON_TPU_FAULT_PLAN`` the parent set (``killhard`` ends it with
    rc 137 mid-journal); writes the frame to OUT.npz and its stats,
    launches, seconds and the kernels' build seconds (0: reused) to
    OUT.json.  Prints no result line."""
    import numpy as np
    import torch

    from cylon_tpu_torch import config
    from cylon_tpu_torch.cuda import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    left, right = _durable_inputs()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=root):
        res, stats, rec = _timed_durable("worker", lambda: _durable_run(
            left, right))
    np.savez(out, **res)
    rec.update(columns=list(res), build_s={
        src: info[0] for src, info in build.BUILD_INFO.items()},
        process_s=time.perf_counter() - t_start)
    with open(os.path.splitext(out)[0] + ".json", "w") as f:
        json.dump(rec, f, default=str)
    return 0


def serve_profile(out: str) -> int:
    """``chip_smoke.py --serve-profile OUT.json``: 3y's ``join_groupby``
    miss (3x's data and call) three ways, each into a fresh journal root,
    after one warm-up call: made directly on the main thread
    (``direct``), served by a ``QueryService`` (``served``, through an
    instance op that wraps the same runner) and made directly on a plain
    thread of its own (``thread``), in the order d s t t s d.  Each call
    records its wall seconds, the engine's plan and run seconds, its span
    seconds, and the CPU seconds and minor page faults of the thread that
    ran it (``RUSAGE_THREAD``).  Then one served and, with the service
    closed, one direct miss under ``cProfile`` (which sees every thread
    from Python 3.12 on, so each profile is taken with no other thread
    running Python).  Writes it all to OUT.json; prints no result
    line."""
    import cProfile
    import pstats
    import resource
    import shutil
    import tempfile
    import threading

    import torch

    from cylon_tpu_torch import config
    from cylon_tpu_torch.exec import chunked_join_groupby_tables
    from cylon_tpu_torch.obs import spans
    from cylon_tpu_torch.serve import QueryService

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    report: dict = {"device": torch.cuda.get_device_name(0)}
    phase_build(report)
    left, right = _durable_inputs()
    kw = dict(on="k", group_by="l_k", agg={"a": ["sum"], "b": ["mean"]},
              passes=DURABLE_PASSES)
    tmp = tempfile.mkdtemp(prefix="cylon_serve_profile_")
    profiles: dict = {}
    thread_use: dict = {}

    def measured(*args, profile=None, **kwargs):
        # runs on whichever thread makes the engine call
        r0 = resource.getrusage(resource.RUSAGE_THREAD)
        prof = cProfile.Profile() if profile else None
        if prof:
            prof.enable()
        try:
            return chunked_join_groupby_tables(*args, **kwargs)
        finally:
            if prof:
                prof.disable()
                profiles[profile] = prof
            r1 = resource.getrusage(resource.RUSAGE_THREAD)
            thread_use.update(
                cpu_s=(r1.ru_utime + r1.ru_stime) - (r0.ru_utime
                                                     + r0.ru_stime),
                sys_s=r1.ru_stime - r0.ru_stime,
                minor_faults=r1.ru_minflt - r0.ru_minflt)

    svc = QueryService()
    svc.register_op("join_groupby_measured", measured)

    def direct(profile=None):
        return measured(left, right, ctx=svc._ctx, profile=profile, **kw)

    def served(profile=None):
        return svc.submit("tenant-a", "join_groupby_measured", left, right,
                          profile=profile, **kw).result(timeout=SERVE_WAIT_S)

    def on_thread(profile=None):
        box = {}
        th = threading.Thread(target=lambda: box.update(r=direct()))
        th.start()
        th.join()
        return box["r"]

    arms = {"warmup": direct, "direct": direct, "served": served,
            "thread": on_thread}
    calls = []

    def call(i, arm, profile=None):
        root = os.path.join(tmp, f"r{i}")
        torch.cuda.synchronize()
        spans.reset_aggregates()
        with config.knob_env(CYLON_TPU_DURABLE_DIR=root):
            t0 = time.perf_counter()
            _, stats = arms[arm](profile=profile)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        if stats.get("passes_skipped"):
            raise AssertionError(f"serve-profile {arm}: not a miss")
        rec = {"arm": arm + ("*" if profile else ""), "seconds": secs,
               "plan_seconds": stats.get("plan_seconds"),
               "run_seconds": stats.get("run_seconds"), **thread_use,
               "spans_s": {k: v[0] for k, v in
                           spans.aggregate_report().items()
                           if v[0] >= 0.005}}
        calls.append(rec)
        log(f"[serve-profile] {json.dumps(rec)}")

    try:
        # a first direct call warms the journal's spill path; the first
        # served call is the service thread's first request, the second
        # a warm one; each thread call runs on a fresh thread
        order = ["warmup", "direct", "served", "thread", "thread", "served",
                 "direct"]
        for i, arm in enumerate(order):
            call(i, arm)
        call(len(order), "served", profile="served")
    finally:
        svc.close()
    try:
        call(len(order) + 1, "direct", profile="direct")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tops = {}
    for label, prof in profiles.items():
        st = pstats.Stats(prof)
        rows = [{"fn": f"{os.path.basename(f)}:{ln}({name})", "calls": nc,
                 "own_s": tt, "cum_s": ct}
                for (f, ln, name), (cc, nc, tt, ct, _) in st.stats.items()]
        tops[label] = {
            "own": sorted(rows, key=lambda r: -r["own_s"])[:40],
            "cum": sorted(rows, key=lambda r: -r["cum_s"])[:60]}
        log(f"[serve-profile] {label} by own time: " + "; ".join(
            f"{r['fn']} {r['own_s']:.3f} s" for r in tops[label]["own"][:12]))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"smi": report["smi"], "env": {
            k: os.environ.get(k) for k in ("MALLOC_ARENA_MAX",)},
            "calls": calls, "profiles": tops}, f, indent=1)
    return 0


def _durable_child(script: str, root: str, out: str, fault: str = None):
    """Run the worker in a fresh process on the same card: (rc, record or
    None, seconds, stderr tail)."""
    env = dict(os.environ)
    env.pop("CYLON_TPU_FAULT_PLAN", None)
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    if fault:
        env["CYLON_TPU_FAULT_PLAN"] = fault
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script, "--durable-worker", root,
                           out], env=env, capture_output=True, text=True,
                          timeout=DURABLE_CHILD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    rec = None
    meta = os.path.splitext(out)[0] + ".json"
    if proc.returncode == 0 and os.path.exists(meta):
        with open(meta) as f:
            rec = json.load(f)
    return proc.returncode, rec, secs, proc.stderr[-3000:]


def _per_part(l8: dict, l1: dict) -> dict:
    """Each kernel's launches per part (C: the exact-sizing count of one
    part) and per pass-program call (P), from an 8-part run (8C + 9P: the
    sizing of each part, the warm-up call, 8 passes) and a one-part
    re-execution (C + 2P)."""
    out = {}
    for k in l8:
        p7 = 8 * l1[k] - l8[k]
        if p7 % 7 or p7 < 0 or l1[k] - 2 * (p7 // 7) < 0:
            raise AssertionError(f"3x: {k} launches {l8[k]} (8 parts) and "
                                 f"{l1[k]} (1 part) fit no k*C + (k+1)*P")
        out[k] = (l1[k] - 2 * (p7 // 7), p7 // 7)
    return out


def phase_durable(report: dict, q10_plan) -> dict:
    """Phase 3x: the run journal on the card.  3v's data at DURABLE_ROWS
    per side through the single-card engine (``_durable_run``) and 3w's
    planned Q10:

    (a) unjournaled, then journaled into an empty root: the frames bit
    for bit equal and equal to the numpy oracle, the launches equal; the
    overhead, spill bytes and ``durable.*`` counters;
    (b) a child process (``--durable-worker``) killed by ``killhard`` at
    its 5th journal commit (rc 137), then a fresh child resumes: 4 passes
    skipped, 4 parts run, the launches of 4 parts (k*C + (k+1)*P, solved
    from (a) and (e)), the build cache reused, the frame bit for bit
    (a)'s;
    (c) (a)'s journaled call again: 8 passes skipped, no kernel launched,
    bit for bit;
    (d) Q10 planned, twice under a journal root: the second call counts
    ``plan.cache_hit`` 1, launches nothing, and returns the first call's
    rows;
    (e) ``bitrot`` of one spill of (a)'s run: without a peer the reload
    re-executes exactly that pass (C + 2P launches); with a
    ``JournalPeerServer`` on 127.0.0.1 over a second root filled by
    ``pull_run``, the reload read-repairs bit for bit and re-executes
    nothing; ``scrub_once`` then finds the root clean.

    Returns the inputs, the unjournaled frame and the oracle of (a) for
    phase 3y."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cylon_tpu_torch import config, durable, durable_sync, resilience

    t_phase = time.perf_counter()
    out: dict = {"rows_per_side": DURABLE_ROWS, "passes": DURABLE_PASSES}
    tmp = tempfile.mkdtemp(prefix="cylon_journal_")
    try:
        left, right = _durable_inputs()
        oracle = _oracle((left["k"], left["a"], right["k"], right["b"]),
                         DURABLE_ROWS)
        root_a = os.path.join(tmp, "a")

        # (a) journaling cost
        base, _, plain = _timed_durable("a unjournaled",
                                        lambda: _durable_run(left, right))
        with config.knob_env(CYLON_TPU_DURABLE_DIR=root_a):
            res, stats, jrec = _timed_durable(
                "a journaled", lambda: _durable_run(left, right))
        _same_frames("3x (a) journaled against unjournaled", res, base)
        if jrec["launches"] != plain["launches"]:
            raise AssertionError(f"3x (a): launches {jrec['launches']} != "
                                 f"unjournaled {plain['launches']}")
        if (stats["passes_skipped"], stats["parts_run"]) != (
                0, DURABLE_PASSES):
            raise AssertionError(f"3x (a): {stats}")
        order = np.argsort(base["l_k"], kind="stable")
        sum_err, mean_err = _check_groups(
            oracle, base["l_k"][order], base["sum_a"][order],
            base["mean_b"][order], "3x (a)")
        (fp_a,) = os.listdir(root_a)
        spill_bytes = jrec["counters"].get("durable.spill_bytes", 0)
        out["a"] = {"unjournaled": plain, "journaled": jrec,
                    "overhead_pct": 100.0 * (jrec["seconds"]
                                             - plain["seconds"])
                    / plain["seconds"],
                    "spill_bytes": spill_bytes,
                    "sum_max_abs_err": sum_err, "mean_max_abs_err": mean_err}
        log(f"[3x] (a) unjournaled {plain['seconds']:.3f} s, journaled "
            f"{jrec['seconds']:.3f} s ({out['a']['overhead_pct']:+.1f}%), "
            f"spill {spill_bytes} B in {DURABLE_PASSES} spills (write "
            f"{jrec['spans_s'].get('durable.spill', 0.0):.3f} s against "
            f"pass compute {jrec['spans_s'].get('exec.pass', 0.0):.3f} s, "
            f"fingerprint "
            f"{jrec['spans_s'].get('durable.fingerprint', 0.0):.3f} s), "
            f"counters {jrec['counters']}; launches {plain['launches']} "
            f"both; bit for bit; {oracle['groups']} groups exact, SUM max "
            f"abs err {sum_err:.3g}, MEAN {mean_err:.3g}")

        # (b) kill and resume in fresh processes on the same card
        gc.collect()
        torch.cuda.empty_cache()
        script = os.path.abspath(__file__)
        root_b = os.path.join(tmp, "b")
        rc, _, kill_s, err = _durable_child(
            script, root_b, os.path.join(tmp, "killed.npz"),
            DURABLE_KILL_PLAN)
        if rc != 137:
            raise AssertionError(f"3x (b): the killed child exited {rc}, "
                                 f"not 137:\n{err}")
        rc, child, resume_s, err = _durable_child(
            script, root_b, os.path.join(tmp, "resumed.npz"))
        if rc != 0 or child is None:
            raise AssertionError(f"3x (b): the resuming child exited "
                                 f"{rc}:\n{err}")
        if (child["passes_skipped"], child["parts_run"]) != (4, 4):
            raise AssertionError(f"3x (b): resumed with "
                                 f"{child['passes_skipped']} skipped, "
                                 f"{child['parts_run']} run, not 4 and 4")
        if any(s > 0 for s in child["build_s"].values()):
            raise AssertionError(f"3x (b): the child rebuilt kernels "
                                 f"{child['build_s']}")
        with np.load(os.path.join(tmp, "resumed.npz")) as z:
            resumed = {k: z[k] for k in child["columns"]}
        _same_frames("3x (b) resumed child against (a)", resumed, base)
        out["b"] = {"killed_rc": 137, "kill_process_s": kill_s,
                    "resume_process_s": resume_s, "resume": child}
        log(f"[3x] (b) child killed at {DURABLE_KILL_PLAN} (rc 137, "
            f"{kill_s:.1f} s); fresh child resumed: 4 skipped, 4 run, "
            f"engine call {child['seconds']:.3f} s (process "
            f"{resume_s:.1f} s), launches {child['launches']}, kernels "
            f"reused; bit for bit (a)")

        # (c) the full hit
        with config.knob_env(CYLON_TPU_DURABLE_DIR=root_a):
            hit, stats, hrec = _timed_durable(
                "c full hit", lambda: _durable_run(left, right))
        if (stats["passes_skipped"], stats.get("parts_run")) != (
                DURABLE_PASSES, None):
            raise AssertionError(f"3x (c): {stats}")
        if any(hrec["launches"].values()):
            raise AssertionError(f"3x (c): the full hit launched "
                                 f"{hrec['launches']}")
        _same_frames("3x (c) full hit against (a)", hit, base)
        t0 = time.perf_counter()
        durable.run_fingerprint("join_groupby", (),
                                ((list(left), left), (list(right), right)))
        fp_s = time.perf_counter() - t0
        out["c"] = {"hit": hrec, "fingerprint_s": fp_s}
        log(f"[3x] (c) full hit {hrec['seconds']:.3f} s: "
            f"{DURABLE_PASSES} skipped, no launch, bit for bit; pass "
            f"planning and fingerprint {hrec['plan_seconds'] - hrec['spans_s'].get('durable.load', 0.0):.3f} s "
            f"(fingerprint alone {fp_s:.3f} s), loads "
            f"{hrec['spans_s'].get('durable.load', 0.0):.3f} s")
        del hit, res

        # (d) planner replay of 3w's Q10
        root_d = os.path.join(tmp, "d")
        with config.knob_env(CYLON_TPU_DURABLE_DIR=root_d):
            first, _, miss = _timed_durable(
                "d Q10 miss", lambda: (q10_plan.execute(), {}))
            second, _, qhit = _timed_durable(
                "d Q10 hit", lambda: (q10_plan.execute(), {}))
        if miss["counters"].get("plan.cache_hit", 0) != 0 or \
                qhit["counters"].get("plan.cache_hit", 0) != 1:
            raise AssertionError(f"3x (d): plan.cache_hit "
                                 f"{miss['counters']} / {qhit['counters']}")
        if any(qhit["launches"].values()) or not any(
                miss["launches"].values()):
            raise AssertionError(f"3x (d): launches {miss['launches']} "
                                 f"then {qhit['launches']}")
        a, b = first.to_pandas(), second.to_pandas()
        if list(a.columns) != list(b.columns) or len(a) != len(b) or any(
                not np.array_equal(a[c].to_numpy(), b[c].to_numpy())
                for c in a.columns):
            raise AssertionError("3x (d): the cache hit's rows differ from "
                                 "the first call's")
        out["d"] = {"miss": miss, "hit": qhit, "rows": len(a)}
        log(f"[3x] (d) Q10 planned under the journal: miss "
            f"{miss['seconds'] * 1e3:.2f} ms (launches {miss['launches']}),"
            f" hit {qhit['seconds'] * 1e3:.2f} ms, plan.cache_hit 1, no "
            f"launch, {len(a)} rows equal")
        del first, second, a, b

        # (e) integrity: bitrot, then reload without and with a peer
        def rot():
            with config.knob_env(CYLON_TPU_DURABLE_DIR=root_a):
                durable.open_run(fp_a, "join_groupby")
            with resilience.fault_plan("rot@1=bitrot"):
                resilience.fault_point("rot")

        rot()
        with config.knob_env(CYLON_TPU_DURABLE_DIR=root_a):
            got, stats, lone = _timed_durable(
                "e reload without a peer", lambda: _durable_run(left, right))
        if (stats["passes_skipped"], stats["parts_run"]) != (
                DURABLE_PASSES - 1, 1) or \
                lone["counters"].get("durable.spills_rejected") != 1:
            raise AssertionError(f"3x (e): without a peer {stats}, "
                                 f"{lone['counters']}")
        _same_frames("3x (e) reload without a peer against (a)", got, base)
        per = _per_part(plain["launches"], lone["launches"])
        if lone["launches"] != {k: c + 2 * p for k, (c, p) in per.items()}:
            raise AssertionError(f"3x (e): {lone['launches']} are not one "
                                 f"part's launches {per}")
        want4 = {k: 4 * c + 5 * p for k, (c, p) in per.items()}
        if child["launches"] != want4:
            raise AssertionError(f"3x (b): the resume launched "
                                 f"{child['launches']}, not 4 parts' "
                                 f"{want4}")
        root_p = os.path.join(tmp, "peer")
        src = durable_sync.JournalPeerServer(root_a)
        try:
            if not durable_sync.pull_run(src.address, root_p, fp_a):
                raise AssertionError("3x (e): pull_run pulled nothing")
        finally:
            src.close()
        peer = durable_sync.JournalPeerServer(root_p)
        durable_sync.set_peers([peer.address])
        try:
            rot()
            with config.knob_env(CYLON_TPU_DURABLE_DIR=root_a):
                got, stats, fixed = _timed_durable(
                    "e reload with a peer",
                    lambda: _durable_run(left, right))
        finally:
            durable_sync.set_peers(())
            peer.close()
        if stats["passes_skipped"] != DURABLE_PASSES or \
                stats.get("parts_run") or any(fixed["launches"].values()) \
                or fixed["counters"].get("durable.read_repair") != 1:
            raise AssertionError(f"3x (e): with a peer {stats}, "
                                 f"{fixed['counters']}, "
                                 f"{fixed['launches']}")
        _same_frames("3x (e) read-repaired reload against (a)", got, base)
        durable._LAST_JOURNAL = None  # the scrubber skips a live run
        scrub = durable_sync.scrub_once(root_a)
        if scrub["checked"] != DURABLE_PASSES or scrub["corrupt"]:
            raise AssertionError(f"3x (e): scrub {scrub}")
        out["e"] = {"without_peer": lone, "with_peer": fixed,
                    "scrub": scrub,
                    "per_part": {k: {"C": c, "P": p}
                                 for k, (c, p) in per.items()}}
        log(f"[3x] (e) bitrot: reload without a peer re-ran 1 pass "
            f"({lone['seconds']:.3f} s, launches {lone['launches']}); with "
            f"a peer on {peer.address[0]} read-repaired, re-ran nothing "
            f"({fixed['seconds']:.3f} s, no launch), bit for bit; scrub "
            f"{scrub}; launches per part (C, P) {per}: the resume's 4 "
            f"parts predicted {want4}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches_durable"] = {
        "a_unjournaled": out["a"]["unjournaled"]["launches"],
        "a_journaled": out["a"]["journaled"]["launches"],
        "b_resume": out["b"]["resume"]["launches"],
        "c_hit": out["c"]["hit"]["launches"],
        "d_miss": out["d"]["miss"]["launches"],
        "d_hit": out["d"]["hit"]["launches"],
        "e_without_peer": out["e"]["without_peer"]["launches"],
        "e_with_peer": out["e"]["with_peer"]["launches"]}
    out["phase_seconds"] = time.perf_counter() - t_phase
    report["durable"] = out
    log(f"[3x] phase {out['phase_seconds']:.1f} s")
    return {"left": left, "right": right, "base": base, "oracle": oracle}


# -- phase 3y: the serving layer on one process -------------------------------

SERVE_STREAM_COLUMNS = ("l_orderkey", "l_quantity", "l_extendedprice",
                        "l_discount")  # lineitem's numeric Q10 columns
SERVE_ORDERS_COLUMNS = ("o_orderkey", "o_custkey", "o_orderdate")
SERVE_BATCHES = 6
SERVE_FLOOD = 12
SERVE_SMALL_ROWS = 1 << 16  # a flood sort's rows
SERVE_WAIT_S = 600.0


def _serve_request(svc, tenant: str, op: str, *args, **kwargs):
    """Submit one request and wait for it, the launch counters zeroed just
    before the submit and read just after the result: (frame, stats,
    record)."""
    import torch

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    ticket = svc.submit(tenant, op, *args, **kwargs)
    frame, stats = ticket.result(timeout=SERVE_WAIT_S)
    torch.cuda.synchronize()
    rec = {"op": op, "tenant": tenant, "seconds": time.perf_counter() - t0,
           "queue_wait_s": ticket.queue_wait_s, "run_s": ticket.duration_s,
           "cache_hit": ticket.cache_hit, "launches": _launch_counts(),
           "passes_skipped": stats.get("passes_skipped"),
           "parts_run": stats.get("parts_run")}
    return frame, stats, rec


def _stream_oracle(batches) -> dict:
    """pandas float64 group-by of the concatenated batches by
    l_orderkey: SUM(l_extendedprice), MEAN(l_quantity), COUNT."""
    import numpy as np
    import pandas as pd

    df = pd.DataFrame({c: np.concatenate([b[c] for b in batches])
                       for c in ("l_orderkey", "l_extendedprice",
                                 "l_quantity")})
    df["l_extendedprice"] = df["l_extendedprice"].astype(np.float64)
    df["l_quantity"] = df["l_quantity"].astype(np.float64)
    g = df.groupby("l_orderkey").agg(
        s=("l_extendedprice", "sum"), m=("l_quantity", "mean"),
        c=("l_quantity", "count"))
    return {"keys": g.index.to_numpy(), "sum": g["s"].to_numpy(),
            "mean": g["m"].to_numpy(), "count": g["c"].to_numpy()}


def _check_stream(label: str, frame: dict, oracle: dict) -> float:
    """Keys and counts exact, SUM and MEAN within F32_SUM_RTOL of the
    float64 oracle; returns the SUM's max abs error."""
    import numpy as np

    if not np.array_equal(frame["l_orderkey"], oracle["keys"]):
        raise AssertionError(f"{label}: group keys differ from the oracle")
    if not np.array_equal(frame["count_l_extendedprice"], oracle["count"]):
        raise AssertionError(f"{label}: counts differ from the oracle")
    err = 0.0
    for col, key in (("sum_l_extendedprice", "sum"),
                     ("mean_l_quantity", "mean")):
        got = np.asarray(frame[col], np.float64)
        want = oracle[key]
        e = np.abs(got - want)
        if not (e <= F32_SUM_RTOL * np.abs(want) + F32_SUM_ATOL).all():
            raise AssertionError(f"{label}: {col} outside rtol "
                                 f"{F32_SUM_RTOL} of the oracle")
        if key == "sum":
            err = float(e.max(initial=0.0))
    return err


def phase_serve(report: dict, q10_plan, tpch: dict, engine: dict) -> None:
    """Phase 3y: the serving layer on one process (see the module
    docstring).  Any failed ticket on the normal path fails the phase."""
    import shutil
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from cylon_tpu_torch import config, resilience
    from cylon_tpu_torch.exec import (chunked_groupby,
                                      chunked_join_groupby_tables,
                                      chunked_sort)
    from cylon_tpu_torch.obs import metrics, openmetrics
    from cylon_tpu_torch.serve import QueryService, TenantBudget
    from cylon_tpu_torch.serve import service as service_mod
    from cylon_tpu_torch.status import Code, CylonError
    from cylon_tpu_torch.stream import GroupByQuery, JoinQuery, StreamTable

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics.reset()
    left, right = engine["left"], engine["right"]
    jg_kw = dict(on="k", group_by="l_k", agg={"a": ["sum"], "b": ["mean"]},
                 passes=DURABLE_PASSES)
    gb_args = (left, "k", {"a": ["sum", "mean", "count"]})
    line = tpch["lineitem"]
    n_line = len(line["l_orderkey"])
    bounds = np.linspace(0, n_line, SERVE_BATCHES + 1).astype(np.int64)
    batches = [{c: line[c][bounds[i]:bounds[i + 1]]
                for c in SERVE_STREAM_COLUMNS} for i in range(SERVE_BATCHES)]
    agg = {"l_extendedprice": ["sum", "count"], "l_quantity": ["mean"]}
    out: dict = {"rows_per_side": DURABLE_ROWS,
                 "stream_rows": n_line, "batches": SERVE_BATCHES}
    tmp = tempfile.mkdtemp(prefix="cylon_serve_")
    try:
        # the same calls without the service (the journal off)
        t0 = time.perf_counter()
        gb_direct, _ = chunked_groupby(*gb_args)
        sort_direct, _ = chunked_sort(left, "k")
        q10_direct = q10_plan.execute().to_numpy()
        direct_s = time.perf_counter() - t0
        keys_all = np.bincount(left["k"], minlength=DURABLE_ROWS)
        gkeys = np.flatnonzero(keys_all)
        order = np.argsort(gb_direct["k"], kind="stable")
        if not np.array_equal(gb_direct["k"][order], gkeys) or \
                not np.array_equal(gb_direct["count_a"][order],
                                   keys_all[gkeys]):
            raise AssertionError("3y: groupby keys or counts differ from "
                                 "the oracle")
        want_sum = np.bincount(left["k"], weights=left["a"].astype(
            np.float64), minlength=DURABLE_ROWS)[gkeys]
        e = np.abs(gb_direct["sum_a"][order].astype(np.float64) - want_sum)
        if not (e <= F32_SUM_RTOL * np.abs(want_sum) + F32_SUM_ATOL).all():
            raise AssertionError("3y: groupby SUM outside rtol of the "
                                 "oracle")
        if not (np.array_equal(sort_direct["k"], np.sort(left["k"]))
                and np.isclose(sort_direct["a"].astype(np.float64).sum(),
                               left["a"].astype(np.float64).sum(),
                               rtol=1e-9)):
            raise AssertionError("3y: the sort is not the sorted input")
        import pandas as pd

        q10_err = _check_query("3y plan", pd.DataFrame(q10_direct),
                               tpch["q10_oracle"],
                               ("c_custkey", "c_nationkey", "n_name"))
        log(f"[3y] direct calls {direct_s:.2f} s; groupby, sort and Q10 "
            f"against their oracles (Q10 revenue max abs err "
            f"{q10_err:.3g})")

        root = os.path.join(tmp, "journal")
        with config.knob_env(CYLON_TPU_DURABLE_DIR=root):
            stream = StreamTable("lineitem")
            for b in batches[:4]:
                stream.append(b)
            query = GroupByQuery(stream, ["l_orderkey"], agg)
            cold4 = query.recompute_cold()
            oracle4 = _stream_oracle(batches[:4])
            _check_stream("3y (d) cold fold at 4", cold4, oracle4)

            # (a) misses and (b) hits, one request at a time
            svc = QueryService()
            try:
                reqs = [
                    ("join_groupby", "tenant-a", (left, right), jg_kw,
                     engine["base"]),
                    ("groupby", "tenant-b", gb_args, {}, gb_direct),
                    ("sort", "tenant-c", (left, "k"), {}, sort_direct),
                    ("plan", "tenant-a", (q10_plan,), {}, q10_direct),
                    ("refresh", "tenant-b", (query,), {}, cold4)]
                recs = {}
                for phase_key in ("a", "b"):
                    recs[phase_key] = []
                    for op, tenant, args, kw, want in reqs:
                        frame, stats, rec = _serve_request(
                            svc, tenant, op, *args, **kw)
                        _same_frames(f"3y ({phase_key}) {op} against the "
                                     f"call without the service", frame,
                                     want)
                        hit = phase_key == "b"
                        if rec["cache_hit"] is not hit:
                            raise AssertionError(f"3y ({phase_key}) {op}: "
                                                 f"cache_hit "
                                                 f"{rec['cache_hit']}")
                        if hit and any(rec["launches"].values()):
                            raise AssertionError(f"3y (b) {op}: a cache hit "
                                                 f"launched "
                                                 f"{rec['launches']}")
                        if not hit and op != "sort" and not any(
                                rec["launches"].values()):
                            # (a sort runs no hand kernel, as in 3o)
                            raise AssertionError(f"3y (a) {op}: a miss "
                                                 f"launched no kernel")
                        recs[phase_key].append(rec)
                        log(f"[3y] ({phase_key}) {op} for {tenant}: queue "
                            f"wait {rec['queue_wait_s'] * 1e3:.2f} ms, run "
                            f"{rec['run_s']:.3f} s, launches "
                            f"{rec['launches']}, cache hit "
                            f"{rec['cache_hit']}; bit for bit")
                out["a"], out["b"] = recs["a"], recs["b"]
                svc_stats = svc.stats()
                telemetry = svc.telemetry()
            finally:
                svc.close()
            if svc_stats["completed"] != 10 or svc_stats["failed"] or \
                    svc_stats["cache_hits"] != 5:
                raise AssertionError(f"3y (a)/(b): service stats "
                                     f"{svc_stats}")
            hits = metrics.counter_value("serve.cache_hit")
            if hits != 5:
                raise AssertionError(f"3y (b): serve.cache_hit {hits}")

            # (d) the stream: batches 5-6, then the refresh at 6
            t0 = time.perf_counter()
            for b in batches[4:]:
                stream.append(b)
            append_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            f6, st6 = query.refresh()
            torch.cuda.synchronize()
            refresh6_s = time.perf_counter() - t0
            launches6 = _launch_counts()
            if (st6["parts_run"], st6["partial_rows"]) != (
                    2, int(bounds[6] - bounds[4])):
                raise AssertionError(f"3y (d): the refresh at 6 folded "
                                     f"{st6}")
            _same_frames("3y (d) refresh at 6 against recompute_cold",
                         f6, query.recompute_cold())
            sum_err = _check_stream("3y (d) refresh at 6", f6,
                                    _stream_oracle(batches))
            first = out["a"][-1]
            dim = tpch["orders"]
            fact = StreamTable("lineitem-join")
            for b in batches[:4]:
                fact.append(b)
            jq = JoinQuery(fact, dim, left_on="l_orderkey",
                           right_on="o_orderkey", how="inner")
            _reset_launches()
            t0 = time.perf_counter()
            j4, jst4 = jq.refresh()
            j4_s = time.perf_counter() - t0
            jl4 = _launch_counts()
            for b in batches[4:]:
                fact.append(b)
            _reset_launches()
            t0 = time.perf_counter()
            j6, jst6 = jq.refresh()
            j6_s = time.perf_counter() - t0
            jl6 = _launch_counts()
            if (jst4["parts_run"], jst6["parts_run"],
                    jst6["passes_skipped"]) != (4, 2, 4):
                raise AssertionError(f"3y (d) join: {jst4} then {jst6}")
            lk = np.concatenate([b["l_orderkey"] for b in batches])
            want_cust = int(dim["o_custkey"][lk].astype(np.int64).sum())
            if len(j6["l_orderkey"]) != n_line or \
                    int(j6["o_custkey"].astype(np.int64).sum()) != want_cust \
                    or not np.array_equal(j6["l_orderkey"],
                                          j6["o_orderkey"]):
                raise AssertionError("3y (d) join: rows differ from the "
                                     "numpy oracle")
            stream.close(unpin=True)
            fact.close(unpin=True)
            query.close(unpin=True)
            jq.close(unpin=True)
        out["d"] = {"append_s": append_s,
                    "refresh4": first, "refresh6_s": refresh6_s,
                    "refresh6_launches": launches6, "refresh6": st6,
                    "sum_max_abs_err": sum_err,
                    "join": {"refresh4_s": j4_s, "launches4": jl4,
                             "refresh6_s": j6_s, "launches6": jl6,
                             "rows": len(j6["l_orderkey"])}}
        log(f"[3y] (d) stream of {n_line} lineitem rows in "
            f"{SERVE_BATCHES} batches: refresh at 4 (served in (a)) "
            f"{first['run_s']:.3f} s launches {first['launches']}; batches "
            f"5-6 appended {append_s:.3f} s; refresh at 6 "
            f"{refresh6_s:.3f} s launches {launches6} ({st6['parts_run']} "
            f"batches, {st6['partial_rows']} rows, {st6['state_groups']} "
            f"groups, state cap {st6['state_cap']}); bit for bit "
            f"recompute_cold, SUM max abs err {sum_err:.3g}; join "
            f"{j4_s:.3f} s (4 probed, launches {jl4}) then {j6_s:.3f} s "
            f"(2 probed, launches {jl6}), {len(j6['l_orderkey'])} rows")

        # (c) overload, unjournaled
        small = [{"k": left["k"][i * SERVE_SMALL_ROWS:
                                 (i + 1) * SERVE_SMALL_ROWS],
                  "a": left["a"][i * SERVE_SMALL_ROWS:
                                 (i + 1) * SERVE_SMALL_ROWS]}
                 for i in range(SERVE_FLOOD)]
        small_direct = [chunked_sort(d, "k", passes=1)[0] for d in small]
        c: dict = {}
        with config.knob_env(CYLON_TPU_SERVE_TENANT_SHARE="0.5"):
            svc = QueryService(queue_cap=8)
            try:
                running = svc.submit("tenant-a", "join_groupby", left,
                                     right, **jg_kw)
                deadline = time.monotonic() + SERVE_WAIT_S
                while running.state == service_mod.QUEUED and \
                        time.monotonic() < deadline:
                    time.sleep(0.001)
                if running.state != service_mod.RUNNING:
                    raise AssertionError(f"3y (c): the join_groupby is "
                                         f"{running.state}, not running")
                flood, shed = [], []
                for i in range(SERVE_FLOOD):
                    try:
                        flood.append((i, svc.submit(
                            "tenant-f", "sort", small[i], "k", passes=1)))
                    except CylonError as e:
                        shed.append(e)
                if not shed or any(
                        e.code != Code.ResourceExhausted
                        or not (e.retry_after_s or 0) > 0 for e in shed):
                    raise AssertionError(f"3y (c): flood sheds "
                                         f"{[str(e) for e in shed]}")
                others = [("tenant-b", svc.submit(
                    "tenant-b", "sort", small[0], "k", passes=1), 0),
                          ("tenant-c", svc.submit(
                              "tenant-c", "sort", small[1], "k",
                              passes=1), 1)]
                cancelled = flood[-1][1]
                if not cancelled.cancel():
                    raise AssertionError("3y (c): cancel of a queued sort "
                                         "returned False")
                with resilience.FaultSchedule().at(
                        "serve.admit", "tenant_flood").install() as plan:
                    try:
                        svc.submit("tenant-c", "sort", small[2], "k",
                                   passes=1)
                        raise AssertionError("3y (c): the tenant_flood "
                                             "fault shed nothing")
                    except CylonError as e:
                        if e.code != Code.ResourceExhausted:
                            raise
                    after = svc.submit("tenant-c", "sort", small[2], "k",
                                       passes=1)
                if plan.fired != [("serve.admit", "tenant_flood", 1)]:
                    raise AssertionError(f"3y (c): fired {plan.fired}")
                svc.set_budget("tenant-m", TenantBudget(hbm_bytes=1))
                try:
                    svc.submit("tenant-m", "sort", small[3], "k", passes=1)
                    raise AssertionError("3y (c): a one-byte budget "
                                         "admitted")
                except CylonError as e:
                    if e.code != Code.ResourceExhausted or \
                            "HBM" not in e.msg:
                        raise
                jg, _ = running.result(timeout=SERVE_WAIT_S)
                _same_frames("3y (c) join_groupby under flood", jg,
                             engine["base"])
                for i, t in flood[:-1]:
                    _same_frames(f"3y (c) flood sort {i}",
                                 t.result(timeout=SERVE_WAIT_S)[0],
                                 small_direct[i])
                try:
                    cancelled.result(timeout=SERVE_WAIT_S)
                    raise AssertionError("3y (c): the cancelled sort ran")
                except CylonError as e:
                    if e.code != Code.Cancelled:
                        raise
                for tenant, t, i in others + [("tenant-c", after, 2)]:
                    _same_frames(f"3y (c) {tenant} sort",
                                 t.result(timeout=SERVE_WAIT_S)[0],
                                 small_direct[i])
                # the drain: a group-by in flight, two sorts queued
                inflight = svc.submit("tenant-b", "groupby", *gb_args)
                while inflight.state == service_mod.QUEUED:
                    time.sleep(0.001)
                queued = [svc.submit("tenant-c", "sort", small[j], "k",
                                     passes=1) for j in (3, 4)]
                drained = svc.drain(timeout=SERVE_WAIT_S)
                if set(drained) != set(queued) or any(
                        q.state != service_mod.SHED
                        or q.error.code != Code.Unavailable
                        for q in queued):
                    raise AssertionError("3y (c): drain did not shed the "
                                         "queue with Unavailable")
                _same_frames("3y (c) in-flight group-by through the drain",
                             inflight.result(timeout=SERVE_WAIT_S)[0],
                             gb_direct)
                c = {"flood_admitted": len(flood), "flood_shed": len(shed),
                     "retry_after_s": [e.retry_after_s for e in shed],
                     "drained": len(drained), "stats": svc.stats()}
            finally:
                svc.close()
        out["c"] = c
        log(f"[3y] (c) flood of {SERVE_FLOOD} sorts during a "
            f"join_groupby: {c['flood_admitted']} admitted, "
            f"{c['flood_shed']} shed ResourceExhausted (retry after "
            f"{min(c['retry_after_s']):.3f}-{max(c['retry_after_s']):.3f} "
            f"s), other tenants exact, one cancelled, tenant_flood shed "
            f"one, a one-byte budget shed at admission, drain shed "
            f"{c['drained']} Unavailable, in-flight exact; stats "
            f"{json.dumps(c['stats'])}")

        # (e) one scrape
        srv = openmetrics.start_server(0)
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30
            ).read().decode()
        finally:
            srv.close()
        doc = openmetrics.parse(body)
        hits = doc["cylon_tpu_serve_cache_hit_total"]["samples"][0][2]
        run_ms = doc["cylon_tpu_serve_run_ms"]["samples"]
        tenants = {lab["tenant"] for _, lab, _ in run_ms}
        les = {lab.get("le") for name, lab, _ in run_ms
               if name.endswith("_bucket")}
        if hits != 5 or not {"tenant-a", "tenant-b", "tenant-c"} <= \
                tenants or "+Inf" not in les or len(les) < 10:
            raise AssertionError(f"3y (e): scrape cache hits {hits}, "
                                 f"tenants {tenants}, le {sorted(les)}")
        out["e"] = {"bytes": len(body), "cache_hit": hits,
                    "tenants": sorted(tenants), "le_buckets": len(les),
                    "telemetry_tenants": sorted(telemetry["tenants"])}
        log(f"[3y] (e) scrape of {len(body)} B parsed: serve_cache_hit "
            f"{hits:g}, run_ms histograms for {sorted(tenants)} with "
            f"{len(les)} le buckets")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches_serve"] = {
        f"{k}_{r['op']}": r["launches"] for k in ("a", "b")
        for r in out[k]}
    out["launches_serve"]["d_refresh6"] = out["d"]["refresh6_launches"]
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["phase_seconds"] = time.perf_counter() - t_phase
    out["smi"] = smi_line()
    report["serve"] = out
    log(f"[3y] phase {out['phase_seconds']:.1f} s, peak device memory "
        f"{out['peak_device_bytes'] / 2**30:.2f} GiB, card {out['smi']}")


FLEET_RANKS = 3
FLEET_PASSES = DURABLE_PASSES
FLEET_KILL_PLAN = "elastic.pass.r1@2=rank_kill"  # dies at its 2nd pass
FLEET_RUN_ID = "chip-3z"
ROUTE_ROWS = 1 << 21  # rows per side of a routed join_groupby
ROUTE_PASSES = 4
FLOOD_REQUESTS = 12
FLOOD_TENANTS = 3
FLOOD_ROWS = 1 << 18  # rows per side of a flood kjoin
FLOOD_KILL_PLAN = "router.pass.r1@3=rank_kill"  # dies at its 3rd kjoin
FLEET_CHILD_TIMEOUT_S = 240
FLEET_SNAPSHOT_S = 0.2


def _write_json(path: str, rec: dict) -> None:
    """Atomic (tmp + rename): a child killed mid-write leaves the last
    whole snapshot.  The tmp name carries the thread too, so two threads
    of one process never rename each other's file away."""
    import threading

    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(rec, f, default=str)
    os.replace(tmp, path)


def _fleet_engine(left, right, ctx, sl=None):
    """3z (a)'s engine call: 3x's, partitioned by splitmix64
    (``mode="hash"``, whose part ids the gang assigns), on ``ctx``; one
    gang member's slice when ``sl`` is an ``elastic.ElasticSlice``."""
    from cylon_tpu_torch.exec import chunked_join_groupby_tables

    return chunked_join_groupby_tables(
        left, right, on="k", group_by="l_k",
        agg={"a": ["sum"], "b": ["mean"]}, passes=FLEET_PASSES,
        mode="hash", ctx=ctx, elastic=sl)


def elastic_worker(rank: str, world: str, addr: str, out: str) -> int:
    """``chip_smoke.py --elastic-worker RANK WORLD ADDR OUT.npz``: one
    member of 3z (a)'s gang.  An ``ElasticConfig`` context (one shard on
    the card) joins the coordinator at ADDR; ``elastic_run`` drives its
    slices of the journaled engine call (``CYLON_TPU_DURABLE_DIR`` from
    the parent) until the gang's rendezvous, then assembles the whole
    frame from the journal.  Writes the frame to OUT.npz and, before each
    pass and at the end, its record (the parts of each epoch, launches,
    seconds, the longest heartbeat gap) to OUT's .json.  A
    ``rank_kill`` in ``CYLON_TPU_FAULT_PLAN`` ends it with rc 137 at a
    pass boundary.  Prints no result line."""
    import numpy as np
    import torch

    from cylon_tpu_torch import CylonContext, ElasticConfig, elastic
    from cylon_tpu_torch.cuda import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    left, right = _durable_inputs()
    ctx = CylonContext.InitDistributed(ElasticConfig(int(rank),
                                                     coordinator=addr))
    agent = ctx.elastic_agent()
    meta = os.path.splitext(out)[0] + ".json"
    rec = {"rank": int(rank), "world": int(world), "epochs": []}

    def snapshot():
        rec.update(beat_gap_max_s=agent.beat_gap_max_s,
                   process_s=time.perf_counter() - t_start)
        _write_json(meta, rec)

    def run_parts(sl):
        ep = {"epoch": sl.epoch, "world": sl.world, "parts": list(sl.parts)}
        rec["epochs"].append(ep)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()

        def guard():
            # the record as of this pass boundary, before the guard's
            # fault probe can end the process
            ep.update(launches=_launch_counts(),
                      seconds=time.perf_counter() - t0)
            snapshot()
            sl.guard()

        try:
            _, stats = _fleet_engine(left, right, ctx, elastic.ElasticSlice(
                sl.parts, sl.epoch, sl.world, guard))
            ep["parts_run"] = stats.get("parts_run", 0)
            ep["passes_skipped"] = stats.get("passes_skipped")
        finally:
            torch.cuda.synchronize()
            ep.update(launches=_launch_counts(),
                      seconds=time.perf_counter() - t0)
            snapshot()

    def finalize():
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        res, stats = _fleet_engine(left, right, ctx)
        torch.cuda.synchronize()
        rec["finalize"] = {"seconds": time.perf_counter() - t0,
                           "launches": _launch_counts(),
                           "passes_skipped": stats.get("passes_skipped"),
                           "parts_run": stats.get("parts_run", 0)}
        return res

    try:
        res = elastic.elastic_run(agent, FLEET_PASSES, run_parts,
                                  finalize=finalize, run_id=FLEET_RUN_ID)
    except elastic.CoordinatorLost as e:
        print(f"rank {rank}: coordinator lost: {e}", file=sys.stderr)
        return 3
    except elastic.EpochChanged as e:
        print(f"rank {rank}: fenced: {e}", file=sys.stderr)
        return 4
    np.savez(out, **res)
    rec.update(epoch=agent.epoch, members=list(agent.members),
               columns=list(res), build_s={
                   src: info[0] for src, info in build.BUILD_INFO.items()})
    snapshot()
    ctx.Finalize()  # a clean leave
    return 0


def replica_worker(rank: str, world: str, addr: str, out: str) -> int:
    """``chip_smoke.py --replica-worker RANK WORLD ADDR OUT.json``: one
    serving replica of 3z (b): a ``QueryService`` on the card behind a
    ``ReplicaServer``, attached to an ``elastic.Agent`` of the router at
    ADDR, with an idempotent ``kjoin`` op behind the fault site
    ``router.pass.r<RANK>``.  Every ``join_groupby`` and ``kjoin`` it
    runs is recorded (launches, run seconds, the request's tag) in
    OUT.json, rewritten after each request and every FLEET_SNAPSHOT_S; it
    stands down when the router goes away.  Prints no result line."""
    import threading

    import torch

    from cylon_tpu_torch import CylonContext, elastic, resilience
    from cylon_tpu_torch.cuda import build
    from cylon_tpu_torch.exec import chunked_join
    from cylon_tpu_torch.router import ReplicaServer
    from cylon_tpu_torch.serve import QueryService
    from cylon_tpu_torch.serve import service as service_mod

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    r = int(rank)
    calls: list = []
    lock = threading.Lock()
    live: dict = {}  # the agent and the replica server, once they exist

    def snapshot():
        with lock:
            rec = {"rank": r, "world": int(world), "calls": list(calls),
                   "beat_gap_max_s": live["agent"].beat_gap_max_s,
                   "address": list(live["rep"].address),
                   "build_s": {src: info[0] for src, info
                               in build.BUILD_INFO.items()},
                   "process_s": time.perf_counter() - t_start}
            # the scheduler thread (after each request) and the main
            # loop both snapshot: one writer at a time, newest last
            _write_json(out, rec)

    def counted(op, runner):
        # the scheduler thread runs one request at a time, so the
        # process-wide launch counters zeroed here are this request's
        def run(*args, **kwargs):
            tag = kwargs.get("tag")
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            res, stats = runner(*args, **kwargs)
            torch.cuda.synchronize()
            with lock:
                calls.append({"op": op, "tag": tag,
                              "run_s": time.perf_counter() - t0,
                              "launches": _launch_counts(),
                              "passes_skipped": stats.get("passes_skipped"),
                              "parts_run": stats.get("parts_run", 0)})
            snapshot()  # before a later request's fault can end us
            return res, stats
        return run

    def kjoin(left, right, *, ctx=None, pass_guard=None, tag=None, **kw):
        resilience.fault_point(f"router.pass.r{r}")
        return chunked_join(left, right, ctx=ctx, pass_guard=pass_guard,
                            **kw)

    service_mod._RUNNERS["join_groupby"] = counted(
        "join_groupby", service_mod._RUNNERS["join_groupby"])
    agent = live["agent"] = elastic.Agent(addr, r).start()
    svc = QueryService(ctx=CylonContext.Init("cuda"), name=f"replica{r}")
    svc.register_op("kjoin", counted("kjoin", kjoin), idempotent=True)
    rep = live["rep"] = ReplicaServer(svc)
    rep.attach(agent)
    try:
        while not (agent.coordinator_down or agent.fenced):
            time.sleep(FLEET_SNAPSHOT_S)
            snapshot()
    finally:
        snapshot()
        rep.close()
        svc.close(timeout=10.0)
    return 0


class _WireClock:
    """Times the router client's request encoding and reply decoding on
    the calling thread (``wire.encode_payload`` / ``wire.decode_value``,
    which ``RouterClient.route`` calls), with the encoded bytes."""

    def __init__(self):
        import threading

        self._local = threading.local()

    def __enter__(self):
        from cylon_tpu_torch.router import wire

        self._enc, self._dec = wire.encode_payload, wire.decode_value
        clock = self

        def encode_payload(args, kwargs):
            t0 = time.perf_counter()
            p = clock._enc(args, kwargs)
            clock._note(encode_s=time.perf_counter() - t0,
                        request_bytes=wire.payload_nbytes(p))
            return p

        def decode_value(v):
            t0 = time.perf_counter()
            nbytes = wire.payload_nbytes(v)
            out = clock._dec(v)
            clock._note(decode_s=time.perf_counter() - t0,
                        reply_bytes=nbytes)
            return out

        wire.encode_payload, wire.decode_value = encode_payload, decode_value
        return self

    def __exit__(self, *exc):
        from cylon_tpu_torch.router import wire

        wire.encode_payload, wire.decode_value = self._enc, self._dec

    def _note(self, **kw):
        self.take().update(kw)

    def take(self) -> dict:
        """This thread's record since the last ``reset``."""
        if getattr(self._local, "rec", None) is None:
            self._local.rec = {}
        return self._local.rec

    def reset(self) -> None:
        self._local.rec = {}


def _wait_all(procs: dict, timeout: float, on_poll=None) -> dict:
    """Wait for every child, polling every 10 ms (``on_poll(now)`` each
    round); the instant each one exited, by key.  Kills the stragglers
    past ``timeout`` and raises."""
    ended: dict = {}
    deadline = time.perf_counter() + timeout
    while len(ended) < len(procs):
        now = time.perf_counter()
        for key, p in procs.items():
            if key not in ended and p.poll() is not None:
                ended[key] = now
        if on_poll is not None:
            on_poll(now)
        if now > deadline:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
            raise AssertionError(f"3z: children {sorted(set(procs) - set(ended))} "
                                 f"still running after {timeout:g} s")
        time.sleep(0.01)
    return ended


def _child_log(tmp: str, key) -> str:
    path = os.path.join(tmp, f"{key[0]}{key[1]}.log")
    try:
        with open(path, errors="replace") as f:
            return f.read()[-3000:]
    except OSError:
        return ""


def phase_fleet(report: dict, engine: dict) -> None:
    """Phase 3z: the fleet on one card (see the module docstring).  Five
    children of this script share the card: three gang members
    (``--elastic-worker``) and two serving replicas
    (``--replica-worker``), started together after the kernels were
    built, so none of them runs ``nvcc``."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from cylon_tpu_torch import CylonContext, config, elastic, pipeline
    from cylon_tpu_torch.exec import chunked_join, chunked_join_groupby_tables
    from cylon_tpu_torch.router import QueryRouter, RouterClient
    from cylon_tpu_torch.status import Code, CylonError

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    script = os.path.abspath(__file__)
    tmp = tempfile.mkdtemp(prefix="cylon_fleet_")
    card = CylonContext.Init("cuda")
    procs: dict = {}
    logs: list = []
    coord = router = None
    out: dict = {"rows_per_side": DURABLE_ROWS, "passes": FLEET_PASSES,
                 "kill_plan": FLEET_KILL_PLAN, "route_rows": ROUTE_ROWS,
                 "flood_rows": FLOOD_ROWS, "flood_kill_plan": FLOOD_KILL_PLAN}
    try:
        coord = elastic.Coordinator(
            FLEET_RANKS, log_dir=os.path.join(tmp, "coord")).start()
        router = QueryRouter(2).start()
        caddr = f"{coord.address[0]}:{coord.address[1]}"
        raddr = f"{router.address[0]}:{router.address[1]}"
        base_env = {k: v for k, v in os.environ.items()
                    if k not in ("CYLON_TPU_FAULT_PLAN",
                                 "CYLON_TPU_DURABLE_DIR",
                                 "CYLON_TPU_COORD_DIR")}
        children = [("gang", r, "--elastic-worker", caddr,
                     os.path.join(tmp, f"gang{r}.npz"),
                     {"CYLON_TPU_DURABLE_DIR": os.path.join(tmp, "gang"),
                      **({"CYLON_TPU_FAULT_PLAN": FLEET_KILL_PLAN}
                         if r == 1 else {})})
                    for r in range(FLEET_RANKS)]
        children += [("replica", r, "--replica-worker", raddr,
                      os.path.join(tmp, f"replica{r}.json"),
                      {"CYLON_TPU_DURABLE_DIR": os.path.join(tmp, "fleet"),
                       "CYLON_TPU_COORD_RECONNECT_S": "0",
                       **({"CYLON_TPU_FAULT_PLAN": FLOOD_KILL_PLAN}
                          if r == 1 else {})})
                     for r in range(2)]
        t_spawn = time.perf_counter()
        for kind, r, flag, addr, path, extra in children:
            log_f = open(os.path.join(tmp, f"{kind}{r}.log"), "w")
            logs.append(log_f)
            world = FLEET_RANKS if kind == "gang" else 2
            procs[(kind, r)] = subprocess.Popen(
                [sys.executable, script, flag, str(r), str(world), addr,
                 path], env={**base_env, **extra}, stdout=log_f,
                stderr=subprocess.STDOUT)

        # (a) the gang: rank 1 dies at its 2nd pass boundary
        gang = {k: p for k, p in procs.items() if k[0] == "gang"}
        seen = {}

        def watch(now):
            if "formed" not in seen and \
                    len(coord.view().members) == FLEET_RANKS:
                seen["formed"] = now
            if "epoch" not in seen and coord.view().epoch >= 1:
                seen["epoch"] = now

        ended = _wait_all(gang, FLEET_CHILD_TIMEOUT_S, watch)
        rcs = {r: gang[("gang", r)].returncode for r in range(FLEET_RANKS)}
        if rcs != {0: 0, 1: 137, 2: 0}:
            raise AssertionError(f"3z (a): exit codes {rcs} (want 1 killed "
                                 f"with 137, 0 and 2 rc 0); rank logs: "
                                 + " | ".join(_child_log(tmp, ("gang", r))
                                              for r in range(FLEET_RANKS)))
        if coord._dead.get(1) != "heartbeat timeout" \
                or coord.view().epoch < 1:
            raise AssertionError(f"3z (a): the ledger says {coord._dead} "
                                 f"at epoch {coord.view().epoch}")
        left, right = engine["left"], engine["right"]
        t0 = time.perf_counter()
        base, _ = _fleet_engine(left, right, card)
        torch.cuda.synchronize()
        base_s = time.perf_counter() - t0
        ranks = {}
        for r in range(FLEET_RANKS):
            with open(os.path.join(tmp, f"gang{r}.json")) as f:
                ranks[r] = json.load(f)
        for r in (0, 2):
            got = dict(np.load(os.path.join(tmp, f"gang{r}.npz")))
            _same_frames(f"3z (a) rank {r}", got, base)
            fin = ranks[r]["finalize"]
            if fin["passes_skipped"] != FLEET_PASSES or \
                    any(fin["launches"].values()):
                raise AssertionError(f"3z (a) rank {r}: finalize {fin}")
        gang_launches: dict = {}
        for r, rec in ranks.items():
            for ep in rec["epochs"]:
                for k, n in (ep.get("launches") or {}).items():
                    gang_launches[k] = gang_launches.get(k, 0) + n
        out["gang"] = {
            "ranks": ranks, "exit_codes": rcs,
            "kill_to_epoch_s": seen["epoch"] - ended[("gang", 1)],
            "spawn_to_formed_s": seen.get("formed", t_spawn) - t_spawn,
            "spawn_to_done_s": max(ended.values()) - t_spawn,
            "base_s": base_s, "launches": gang_launches,
            "dead": dict(coord._dead), "epoch": coord.view().epoch}
        for r, rec in ranks.items():
            log(f"[3z] (a) rank {r} rc {rcs[r]}: epochs " + "; ".join(
                f"{ep['epoch']}: parts {ep['parts']} launches "
                f"{ep.get('launches')} in {ep.get('seconds', 0):.2f} s"
                for ep in rec["epochs"]) + f"; finalize "
                f"{rec.get('finalize')}; process {rec['process_s']:.2f} s, "
                f"longest heartbeat gap {rec['beat_gap_max_s']:.3f} s")
        log(f"[3z] (a) kill -> epoch bump {out['gang']['kill_to_epoch_s']:.3f}"
            f" s; ledger {coord._dead}; survivors bit for bit the one-process "
            f"run ({base_s:.2f} s); gang launches {gang_launches}")

        # (b) the router over the two replicas
        deadline = time.perf_counter() + FLEET_CHILD_TIMEOUT_S
        while len(router._replica_view()) < 2:
            if time.perf_counter() > deadline or any(
                    procs[("replica", r)].poll() is not None
                    for r in range(2)):
                raise AssertionError("3z (b): the replicas never registered: "
                                     + _child_log(tmp, ("replica", 0)))
            time.sleep(0.05)
        lk, lv, rk, rv = pipeline.make_data(ROUTE_ROWS, pipeline.SEED)
        r_left, r_right = {"k": lk, "a": lv}, {"k": rk, "b": rv}
        rkw = dict(on="k", group_by="l_k", agg={"a": ["sum"], "b": ["mean"]},
                   passes=ROUTE_PASSES)
        direct, _ = chunked_join_groupby_tables(r_left, r_right, ctx=card,
                                                **rkw)
        client = RouterClient(raddr)
        requests = []
        with _WireClock() as wclock:
            for step, tenant in (("miss", "tenant-a"), ("hit", "tenant-a"),
                                 ("other", "tenant-b")):
                if step == "other":
                    # pin tenant-b to the replica that did not serve the
                    # miss; cache affinity off, so the pin decides
                    other = 1 - requests[0]["replica"]
                    router._pin(router._tenant_affinity, "tenant-b", other)
                wclock.reset()
                t0 = time.perf_counter()
                with config.knob_env(CYLON_TPU_ROUTER_CACHE_AFFINITY=(
                        "0" if step == "other" else None)):
                    res, stats = client.route(tenant, "join_groupby", r_left,
                                              r_right, timeout_s=300, **rkw)
                secs = time.perf_counter() - t0
                _same_frames(f"3z (b) {step}", res, direct)
                requests.append({"step": step, "tenant": tenant,
                                 "route_s": secs,
                                 "replica": stats["router"]["replica"],
                                 "cache_hit": stats["router"]["cache_hit"],
                                 "reroutes": stats["router"]["reroutes"],
                                 **wclock.take()})
        if [q["cache_hit"] for q in requests] != [False, True, True] or \
                requests[1]["replica"] != requests[0]["replica"] or \
                requests[2]["replica"] == requests[0]["replica"]:
            raise AssertionError(f"3z (b): placement or hits {requests}")

        flood = [(f"flood-t{i % FLOOD_TENANTS}", pipeline.make_data(
            FLOOD_ROWS, pipeline.SEED + 1 + i)) for i in range(FLOOD_REQUESTS)]
        fkw = dict(on="k", passes=2, mode="hash")
        flood_direct = [chunked_join({"k": d[0], "a": d[1]},
                                     {"k": d[2], "b": d[3]}, ctx=card,
                                     **fkw)[0] for _, d in flood]
        answers: list = [None] * FLOOD_REQUESTS

        def one(i):
            tenant, d = flood[i]
            t0 = time.perf_counter()
            try:
                res, stats = client.route(
                    tenant, "kjoin", {"k": d[0], "a": d[1]},
                    {"k": d[2], "b": d[3]}, tag=i, timeout_s=300, **fkw)
                try:
                    _same_frames(f"3z (b) flood {i}", res, flood_direct[i])
                    same = True
                except AssertionError:
                    same = False
                answers[i] = {"i": i, "tenant": tenant, "answered": True,
                              "bit_identical": same,
                              "route_s": time.perf_counter() - t0,
                              "replica": stats["router"]["replica"],
                              "reroutes": stats["router"]["reroutes"]}
            except CylonError as e:
                answers[i] = {"i": i, "tenant": tenant, "answered": False,
                              "route_s": time.perf_counter() - t0,
                              "code": e.code.name,
                              "retry_after_s": e.retry_after_s,
                              "error": e.msg[:200]}

        t_flood = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(FLOOD_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        flood_s = time.perf_counter() - t_flood
        if any(t.is_alive() for t in threads) or None in answers:
            raise AssertionError("3z (b): a flood request hung")
        for a in answers:
            if a["answered"] and not a["bit_identical"]:
                raise AssertionError(f"3z (b): flood request {a['i']} "
                                     "differs from the direct call")
            if not a["answered"] and (
                    a["code"] not in (Code.Unavailable.name,
                                      Code.ResourceExhausted.name)
                    or a["retry_after_s"] is None):
                raise AssertionError(f"3z (b): flood request {a} failed "
                                     "unclassified")
        if procs[("replica", 1)].wait(timeout=60) != 137:
            raise AssertionError("3z (b): replica 1 was not killed: "
                                 + _child_log(tmp, ("replica", 1)))
        deadline = time.perf_counter() + 30
        while 1 not in router._dead:
            if time.perf_counter() > deadline:
                raise AssertionError("3z (b): replica 1 never fenced")
            time.sleep(0.05)
        rstat = router.router_status()
        if rstat["reroutes"] < 1:
            raise AssertionError(f"3z (b): no re-route ({rstat})")
        fs = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(script), "tools",
                                          "fleet_status.py"), raddr,
             "--json", "--replicas"], capture_output=True, text=True,
            timeout=60)
        table = json.loads(fs.stdout) if fs.returncode == 0 else None
        if table is None or set(table["breakers"]) != {"0", "1"}:
            raise AssertionError(f"3z (b): fleet_status rc {fs.returncode}: "
                                 f"{fs.stdout[-500:]} {fs.stderr[-500:]}")
        router.stop()
        _wait_all({k: p for k, p in procs.items() if k[0] == "replica"},
                  60)
        if procs[("replica", 0)].returncode != 0:
            raise AssertionError("3z (b): replica 0 rc "
                                 f"{procs[('replica', 0)].returncode}: "
                                 + _child_log(tmp, ("replica", 0)))
        replicas = {}
        for r in range(2):
            with open(os.path.join(tmp, f"replica{r}.json")) as f:
                replicas[r] = json.load(f)
        # each replica's join_groupby calls in order are its share of
        # the three routed requests, in order
        jg = {r: [c for c in replicas[r]["calls"]
                  if c["op"] == "join_groupby"] for r in range(2)}
        for q in requests:
            c = jg[q["replica"]].pop(0)
            q.update(serve_run_ms=c["run_s"] * 1e3, launches=c["launches"],
                     passes_skipped=c["passes_skipped"])
        if any(requests[i]["launches"].get(k) for i in (1, 2)
               for k in requests[i]["launches"]):
            raise AssertionError(f"3z (b): a journal hit launched "
                                 f"{requests}")
        by_tag = {c["tag"]: (r, c) for r in range(2)
                  for c in replicas[r]["calls"] if c["op"] == "kjoin"}
        for a in answers:
            hit = by_tag.get(a["i"])
            if hit is not None:
                a.update(ran_on=hit[0], serve_run_ms=hit[1]["run_s"] * 1e3,
                         launches=hit[1]["launches"])
        router_launches: dict = {}
        for r in range(2):
            for c in replicas[r]["calls"]:
                for k, n in c["launches"].items():
                    router_launches[k] = router_launches.get(k, 0) + n
        out["router"] = {
            "requests": requests, "flood": answers, "flood_s": flood_s,
            "answered": sum(a["answered"] for a in answers),
            "refused": sum(not a["answered"] for a in answers),
            "router_status": rstat, "fleet_status": table,
            "replica_beat_gap_max_s": {
                r: replicas[r]["beat_gap_max_s"] for r in range(2)},
            "launches": router_launches}
        for q in requests:
            log(f"[3z] (b) {q['step']} ({q['tenant']}): route "
                f"{q['route_s']:.3f} s on replica {q['replica']}, serve.run_ms"
                f" {q['serve_run_ms']:.1f}, cache hit {q['cache_hit']}, "
                f"launches {q['launches']}; wire {q.get('request_bytes')} B "
                f"out / {q.get('reply_bytes')} B back, encode "
                f"{q.get('encode_s', 0):.3f} s, decode "
                f"{q.get('decode_s', 0):.3f} s")
        for a in answers:
            log(f"[3z] (b) flood {a['i']} ({a['tenant']}): "
                + (f"served by replica {a['replica']} in {a['route_s']:.3f} s"
                   f" (reroutes {a['reroutes']}, serve.run_ms "
                   f"{a.get('serve_run_ms', 0):.1f}, launches "
                   f"{a.get('launches')})" if a["answered"] else
                   f"refused {a['code']} retry after {a['retry_after_s']} s "
                   f"after {a['route_s']:.3f} s"))
        log(f"[3z] (b) flood {flood_s:.2f} s: {out['router']['answered']} "
            f"answered bit for bit, {out['router']['refused']} refused "
            f"classified; router reroutes {rstat['reroutes']}, abandoned "
            f"{rstat['abandoned']}; replica 1 fenced "
            f"({router._dead.get(1)}); fleet_status breakers "
            f"{table['breakers']}; replica heartbeat gaps "
            f"{out['router']['replica_beat_gap_max_s']}; launches "
            f"{router_launches}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
        if router is not None:
            router.stop()
        if coord is not None:
            coord.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches_fleet"] = {"gang": out["gang"]["launches"],
                             "router": out["router"]["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    out["smi"] = smi_line()
    report["fleet"] = out
    log(f"[3z] phase {out['seconds']:.1f} s, card {out['smi']}")


# -- phase 3aa: the BASELINE example drivers ---------------------------------

# Every scale below is the full preset's except where cut for the
# script's time (PERF.md §4): host work leads each driver's wall, mostly
# the upload of lineitem's two object-array flag columns (encoded per
# cell on the host) and the pandas checks
EXAMPLE_JOIN_ROWS = 1 << 19  # rows per CSV, cut from 5M: writing is host-bound
EXAMPLE_Q1_SF = 0.1  # Q1, Q6 and eager Q5, cut from SF-1
EXAMPLE_Q3_SF = 0.1  # cut from SF-0.5
EXAMPLE_Q5_OOC_PASSES = 4  # SF-1 (3w's tables) in 4 passes, cut from SF-10
EXAMPLE_SHUFFLE_ROWS = 1 << 24  # cut from 2^27 (the Parquet egress)
# 2^23 rows per pass, cut from the full preset's 2^26 (2^30 in 16); 3p
# already runs 2^30 rows
EXAMPLE_SHUFFLE_OOC = dict(rows=1 << 24, world=8, passes=2)
EXAMPLE_SCALING_ROWS = 1 << 22  # rows per shard, weak
EXAMPLE_ETL = dict(events=2_000_000, users=5_000, steps=50)


def _join_csv_oracle(rows: int, seed: int = 0) -> int:
    """Inner-join rows of ``join_csv``'s two files: its keys drawn again
    from the seed, per key the product of the two sides' counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = []
    for _ in range(2):
        counts.append(np.bincount(rng.integers(0, rows, rows),
                                  minlength=rows))
        rng.random(rows)
    return int((counts[0] * counts[1]).sum())


def phase_examples(report: dict, tpch: dict) -> None:
    """Phase 3aa: each BASELINE example driver of
    ``cylon_tpu_torch/examples`` through its ``run`` on the card, with
    its golden check on; the launch counters zeroed just before each and
    read just after; every kernel must launch in the phase.  ``tpch``
    holds 3w's SF-1 host tables and Q5 oracle, which the out-of-core Q5
    chain reuses (the same draw: seed 0, Q5's order)."""
    import math
    import shutil
    import tempfile

    import torch

    from cylon_tpu_torch.examples import (etl_to_torch, join_csv, scaling,
                                          shuffle_bench, tpch_q1, tpch_q3,
                                          tpch_q5, tpch_q6)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cylon_examples_")
    raw, golden = tpch["raw"], tpch["q5_oracle"]
    runs = (
        ("join_csv", lambda: join_csv.run(EXAMPLE_JOIN_ROWS)),
        ("tpch_q1", lambda: tpch_q1.run(EXAMPLE_Q1_SF)),
        ("tpch_q3", lambda: tpch_q3.run(EXAMPLE_Q3_SF)),
        ("tpch_q6", lambda: tpch_q6.run(EXAMPLE_Q1_SF)),
        ("tpch_q5", lambda: tpch_q5.run(EXAMPLE_Q1_SF)),
        ("tpch_q5_ooc", lambda: tpch_q5.run_ooc(
            TPCH_SF, passes=EXAMPLE_Q5_OOC_PASSES, check=True, raw=raw,
            golden=golden)),
        # SHARDS shards: on one shard Table.shuffle returns its input
        ("shuffle", lambda: shuffle_bench.run(
            EXAMPLE_SHUFFLE_ROWS, world=SHARDS,
            out_dir=os.path.join(tmp, "shuffle"))),
        ("shuffle_ooc", lambda: shuffle_bench.run_ooc(
            **EXAMPLE_SHUFFLE_OOC, out_dir=os.path.join(tmp, "ooc"))),
        ("scaling", lambda: scaling.run(EXAMPLE_SCALING_ROWS, "weak",
                                        max_world=SHARDS)),
        ("etl_to_torch", lambda: etl_to_torch.run(**EXAMPLE_ETL)),
    )
    out: dict = {"drivers": {}}
    try:
        for name, fn in runs:
            torch.cuda.synchronize()
            _reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rec = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = {"record": rec, "wall_s": wall, "launches": _launch_counts(),
                 "peak_device_bytes": torch.cuda.max_memory_allocated()}
            out["drivers"][name] = d
            log(f"[3aa] {name}: wall {wall:.2f} s, launches "
                f"{d['launches']}, peak "
                f"{d['peak_device_bytes'] / 2**30:.2f} GiB; record "
                f"{json.dumps(rec)}")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    drivers = out["drivers"]
    want = _join_csv_oracle(EXAMPLE_JOIN_ROWS)
    if drivers["join_csv"]["record"]["out_rows"] != want:
        raise AssertionError(f"3aa join_csv: {drivers['join_csv']['record']}"
                             f" against the oracle's {want} rows")
    worlds = [r["world"] for r in drivers["scaling"]["record"]]
    if worlds != [1, 2, SHARDS] or not all(
            r[k] > 0 for r in drivers["scaling"]["record"]
            for k in ("shuffle_rows_per_sec", "join_rows_per_sec",
                      "groupby_rows_per_sec")):
        raise AssertionError(f"3aa scaling: {drivers['scaling']['record']}")
    if not math.isfinite(drivers["etl_to_torch"]["record"]["final_loss"]):
        raise AssertionError("3aa etl_to_torch: the loss is not finite")
    totals = {k: sum(d["launches"].get(k, 0) for d in drivers.values())
              for k in KERNELS}
    if min(totals.values()) < 1:
        raise AssertionError(f"3aa did not launch every kernel: {totals}")
    out["launches"] = totals
    out["seconds"] = time.perf_counter() - t_phase
    out["smi"] = smi_line()
    report["examples"] = out
    log(f"[3aa] launches over the phase {totals}; phase "
        f"{out['seconds']:.1f} s, card {out['smi']}")


def phase_cylint(report: dict, device: str = "cuda") -> None:
    """Phase 3ab: the port's cylint on the card (see the module doc).
    ``device="cpu"`` rehearses it off the card.  Any finding fails the
    run; nothing falls back to the CPU."""
    import torch

    from cylon_tpu_torch.analysis import astlint, budgets, locks
    from cylon_tpu_torch.context import CylonContext

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def fail(part: str, found) -> None:
        raise AssertionError(f"3ab ({part}): " + "\n".join(
            f.render() for f in found))

    t_phase = time.perf_counter()
    out: dict = {"budgets": {}}
    # (a) each entry on its own, the package's launch counters around it
    t0 = time.perf_counter()
    traced = {}
    for name in budgets.ENTRIES:
        sync()
        _reset_launches()
        # the mesh's counts; the group's (CPU processes over gloo: one
        # card holds no two-rank NCCL group) are the CPU tests' and CLI's
        traced.update(budgets.trace_budgets([name], device=device,
                                            group=False))
        sync()
        launches = _launch_counts()
        out["budgets"][name] = {"realizations": traced[name],
                                "launches": launches}
        for real, counts in traced[name].items():
            log(f"[3ab] budget {name}/{real}: collectives "
                f"{ {k: v for k, v in counts['collectives'].items() if v} }"
                f", hand-kernel calls "
                f"{ {k: v for k, v in counts['informational'].items() if v} }")
        log(f"[3ab] budget {name}: kernel launches {launches}")
    found = budgets.check_budgets(traced=traced, group=False)
    if found:
        fail("a", found)
    out["budgets_seconds"] = time.perf_counter() - t0
    # (b) the lock-graph smoke, the service on the card
    t0 = time.perf_counter()
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cylon_tpu_torch")
    modules = astlint.parse_paths([pkg])  # parsed once for (b) and (c)
    static = locks.static_edges(locks.build_inventory(modules))
    observed = locks.smoke_observed(CylonContext.Init(device))
    found = locks.check_lockgraph(observed, static)
    if found:
        fail("b", found)
    if not observed:
        raise AssertionError("3ab (b): the smoke observed no lock-order edge")
    out["lockgraph"] = {"observed": sorted(map(list, observed)),
                        "static_edges": len(static),
                        "seconds": time.perf_counter() - t0}
    log(f"[3ab] lock graph: {len(observed)} observed edges, all in the "
        f"golden and the {len(static)}-edge static graph "
        f"({out['lockgraph']['seconds']:.1f} s)")
    # (c) the scan of the package
    t0 = time.perf_counter()
    found = astlint.scan_modules(modules)
    if found:
        fail("c", found)
    out["scan"] = {"modules": len(modules),
                   "seconds": time.perf_counter() - t0}
    out["launches"] = {k: sum(e["launches"].get(k, 0)
                              for e in out["budgets"].values())
                       for k in KERNELS}
    out["seconds"] = time.perf_counter() - t_phase
    out["smi"] = smi_line() if device != "cpu" else "cpu"
    report["cylint"] = out
    log(f"[3ab] budgets {out['budgets_seconds']:.1f} s, scan of "
        f"{len(modules)} modules clean ({out['scan']['seconds']:.1f} s); "
        f"launches {out['launches']}; phase {out['seconds']:.1f} s, card "
        f"{out['smi']}")


def _segmented_inputs(tables, out_cap):
    """The segmented scan's inputs on the main path: the join output's
    masked SUM column and its group boundaries, built as
    ``pipeline_groupby`` builds them."""
    import torch

    from cylon_tpu_torch.config import JoinType
    from cylon_tpu_torch.ops import join, keys

    joined, jm = join.join_gather(*tables, (0,), (0,),
                                  JoinType.INNER, out_cap, "sort",
                                  key_grouped=True, project=(0, 1, 3))
    ops = [keys.padding_operand(out_cap, jm, jm.device)]
    ops += keys.column_operands(joined[0])
    new_group = ~keys.rows_equal_adjacent(keys.pack_operands(ops))
    live = torch.arange(out_cap, device=jm.device) < jm
    v = joined[1]
    x = torch.where(v.validity & live, v.data, torch.zeros_like(v.data))
    return x.contiguous(), new_group.contiguous()


def _hash_timing_row(report: dict, main: dict, dist: dict) -> dict:
    """The hash kernel at the distributed path's shape (one shard's int32
    key with validity, 2^24 rows) and at the whole table's (2^26)."""
    from cylon_tpu_torch.ops import hash_kernels

    per_size = {}
    for label, col in (("shard", dist["left"].shards[0][0]),
                       ("table", main["tables"][0][0])):
        n = col.capacity
        per_size[label] = {
            "n": n,
            "ms": cuda_time_ms(lambda: hash_kernels.hash_partition([col],
                                                                   SHARDS)),
            "plain_ms": cuda_time_ms(
                lambda: hash_kernels.hash_partition_plain([col], SHARDS), 3),
            "bound_ms": KERNELS["hash_partition"][1] * n / HBM_BYTES_PER_S
            * 1e3}
    report["hash_partition_sizes"] = per_size
    log(f"[4] hash_partition sizes: {json.dumps(per_size)}")
    head = per_size["shard"]
    return dict(
        name="hash_partition", route="cuda", source=HASH_SOURCE,
        replaces=KERNELS["hash_partition"][0],
        launches=dist["launches"]["hash_partition"],
        max_abs_err=report.get("max_abs_err", {}).get("hash_partition", 0.0),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=None,
        checks_passed=report.get("checks_passed", {}).get("hash_partition",
                                                          0))


def operator_launches(report: dict) -> dict:
    """Per kernel, its launches summed over the first runs of phases 3d
    and 3e."""
    total: dict = {}
    for phase in ("operators", "distributed_operators"):
        for r in report.get(phase, {}).values():
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
    return total


def string_launches(report: dict) -> dict:
    """Per kernel, its launches summed over the first runs of phases 3f,
    3g (join -> group-by and sort) and 3h (both shard counts)."""
    runs = [report.get("string_join", {}),
            report.get("string_distributed", {}),
            report.get("string_distributed", {}).get("distributed_sort", {})]
    runs += [v for k, v in report.get("tpch_q1", {}).items()
             if k.endswith(("shard", "shards"))]
    total: dict = {}
    for r in runs:
        for k, n in r.get("launches", {}).items():
            total[k] = total.get(k, 0) + n
    return total


def phase_timings(report: dict, main: dict, dist: dict, rows: int) -> list:
    import torch

    from cylon_tpu_torch.ops import scan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    x, reset = _segmented_inputs(main["tables"], main["out_cap"])
    launches = main["launches"]
    seg_err = _compare("segmented_scan main-path input",
                       scan.segmented_scan(x, reset, "sum"),
                       scan.segmented_scan_plain(x, reset, "sum"), False,
                       _f32_oracle(x, reset))
    errs = dict(report.get("max_abs_err", {}))
    errs["segmented_scan"] = max(errs.get("segmented_scan", 0.0), seg_err)

    # run_extents' three scans over the combined sorted order of both
    # sides, at both main-path shapes: single chip, 2 * rows; one shard of
    # the distributed path, 2 * 2 * rows / SHARDS (each shard's capacity
    # after the shuffle is the pow2ceil of just over rows / SHARDS rows)
    rows_out = []
    scan_variants = {}
    for n_s in (2 * rows, 4 * rows // SHARDS):
        member = torch.randint(0, 2, (n_s,), generator=gen, device=dev,
                               dtype=torch.int32)
        for op, rev, lib, reps in (
                ("sum", False, lambda: torch.cumsum(member, 0,
                                                    dtype=torch.int32), 10),
                ("max", False, lambda: torch.cummax(member, 0), 3),
                ("min", True, None, 0)):
            scan_variants[f"{op}{'_rev' if rev else ''}@{n_s}"] = {
                "n": n_s,
                "ms": cuda_time_ms(lambda: scan.scan_1d(member, op, rev)),
                "plain_ms": cuda_time_ms(
                    lambda: scan.scan_1d_plain(member, op, rev), 3),
                "library_ms": cuda_time_ms(lib, reps) if lib else None,
                "bound_ms": KERNELS["scan_1d"][1] * n_s / HBM_BYTES_PER_S
                * 1e3}
        del member
    head = scan_variants[f"sum@{2 * rows}"]
    rows_out.append(dict(
        name="scan_1d", route="cuda", source=SCAN_SOURCE,
        replaces=KERNELS["scan_1d"][0], launches=launches["scan_1d"],
        max_abs_err=errs.get("scan_1d", 0.0), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=head["library_ms"],
        checks_passed=report.get("checks_passed", {}).get("scan_1d", 0)))

    m = x.shape[0]
    s_ms = cuda_time_ms(lambda: scan.segmented_scan(x, reset, "sum"))
    sp_ms = cuda_time_ms(lambda: scan.segmented_scan_plain(x, reset, "sum"), 3)
    rows_out.append(dict(
        name="segmented_scan", route="cuda", source=SCAN_SOURCE,
        replaces=KERNELS["segmented_scan"][0],
        launches=launches["segmented_scan"],
        max_abs_err=errs["segmented_scan"], ms=s_ms, plain_ms=sp_ms,
        bound_ms=KERNELS["segmented_scan"][1] * m / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None,
        checks_passed=report.get("checks_passed", {}).get(
            "segmented_scan", 0) + 1))
    rows_out.append(_hash_timing_row(report, main, dist))
    report["scan_1d_variants"] = scan_variants
    report["segmented_inputs"] = {"n": m, "resets": int(reset.sum())}
    op_launches = operator_launches(report)
    str_launches = string_launches(report)
    exchange = exchange_launches(report)
    surface: dict = {}
    for r in report["distributed_surface"].values():
        for k, n in r["launches"].items():
            surface[k] = surface.get(k, 0) + n
    for r in rows_out:
        r["launches_operators"] = op_launches.get(r["name"], 0)
        r["launches_strings"] = str_launches.get(r["name"], 0)
        r["launches_hash_join"] = report["hash_join"]["launches"].get(
            r["name"], 0)
        r["launches_distributed_surface"] = surface.get(r["name"], 0)
        r["launches_exchange"] = exchange.get(r["name"], 0)
        r["launches_process_group"] = report["process_group"][
            "launches"].get(r["name"], 0)
        r["launches_realizations"] = report["realizations"][
            "launches"].get(r["name"], 0)
    for r in rows_out:
        log(f"[4] {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
            f"ms, plain {r['plain_ms']:.3f} ms, library {r['library_ms']}) "
            f"launches/run {r['launches']}")
    for name, v in scan_variants.items():
        log(f"[4] scan_1d {name}: {v['ms']:.3f} ms (bound {v['bound_ms']:.3f}"
            f" ms, {v['ms'] / v['bound_ms']:.2f}x; plain {v['plain_ms']:.3f}"
            f" ms, library {v['library_ms']})")
    log(f"[4] segmented_scan at n={m}, resets={int(reset.sum())}")
    return rows_out


def _clocked(phase, report: dict, *args, **kwargs):
    """Run one phase; its wall seconds go to ``report["phase_wall_s"]``
    under the function's name, and a failed phase's too."""
    t0 = time.perf_counter()
    try:
        return phase(report, *args, **kwargs)
    finally:
        report.setdefault("phase_wall_s", {})[phase.__name__] = \
            time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--durable-worker", nargs=2, metavar=("ROOT", "OUT"),
                    help="phase 3x's child: one journaled engine run into "
                         "ROOT, its frame to OUT (.npz) and its record to "
                         "OUT's .json; prints no result")
    ap.add_argument("--elastic-worker", nargs=4,
                    metavar=("RANK", "WORLD", "ADDR", "OUT"),
                    help="phase 3z's gang member: joins the coordinator at "
                         "ADDR, runs its slices of the journaled engine and "
                         "writes the assembled frame to OUT (.npz); prints "
                         "no result")
    ap.add_argument("--replica-worker", nargs=4,
                    metavar=("RANK", "WORLD", "ADDR", "OUT"),
                    help="phase 3z's serving replica: a QueryService on the "
                         "card behind a ReplicaServer of the router at ADDR, "
                         "its record in OUT (.json); prints no result")
    ap.add_argument("--serve-profile", metavar="OUT",
                    help="time 3y's served join_groupby miss against the "
                         "direct call, with a host profile of each, into "
                         "OUT (.json); prints no result")
    ap.add_argument("--profile", action="store_true",
                    help="profile one run of each main path, of the set "
                         "ops, of the distributed sorts, of the string "
                         "paths and of Q1, and time the stages of one "
                         "distributed run")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from cylon_tpu_torch import pipeline
    except ImportError as e:
        print(f"chip_smoke: cylon_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 2
    if args.durable_worker:
        return durable_worker(*args.durable_worker)
    if args.elastic_worker:
        return elastic_worker(*args.elastic_worker)
    if args.replica_worker:
        return replica_worker(*args.replica_worker)
    if args.serve_profile:
        return serve_profile(args.serve_profile)

    t_start = time.perf_counter()
    report: dict = {"device": torch.cuda.get_device_name(0)}
    kernels = []
    try:
        _clocked(phase_build, report)
        _clocked(phase_kernels, report)
        main_state = _clocked(phase_main_path, report, ROWS)
        if args.profile:
            phase_profile(report, "single_chip", lambda: pipeline.join_groupby(
                *main_state["tables"], main_state["out_cap"]))
        dist = _clocked(phase_distributed, report, main_state, ROWS)
        if args.profile:
            phase_profile(report, "distributed",
                          lambda: pipeline.distributed_join_groupby(
                              dist["left"], dist["right"]))
            phase_stages(report, dist)
        _clocked(phase_hash_partition, report, dist, ROWS)
        ops = _clocked(phase_operators, report, main_state, ROWS)
        if args.profile:
            calls = pipeline.operator_calls(ops["left"], ops["right"])
            phase_profile(report, "set_ops", lambda: [
                calls[op]() for op in ("union", "intersect", "subtract",
                                       "union_rows")])
        _clocked(phase_distributed_operators, report, main_state, dist, ops,
                 ROWS)
        if args.profile:
            phase_profile(report, "distributed_sort",
                          lambda: dist["left"].distributed_sort("k"))
        del ops
        _clocked(phase_string_join, report, main_state, ROWS, args.profile)
        _clocked(phase_string_distributed, report, main_state, ROWS,
                 args.profile)
        q1 = _clocked(phase_tpch_q1, report, args.profile)
        _clocked(phase_hash_join, report, main_state, ROWS, args.profile)
        _clocked(phase_distributed_surface, report, main_state, dist, ROWS)
        _clocked(phase_exchange, report, main_state, dist, q1, ROWS,
                 args.profile)
        del q1
        _clocked(phase_process_group, report, main_state, dist, ROWS)
        _clocked(phase_realizations, report, main_state, dist, ROWS)
        kernels = _clocked(phase_timings, report, main_state, dist, ROWS)
        del main_state, dist
        gc.collect()
        torch.cuda.empty_cache()
        data = _clocked(phase_out_of_core, report, profile=args.profile)
        prefix = _prefix_oracle(data, OOC_PREFIX_ROWS)
        _clocked(phase_ooc_groupby, report, data, prefix,
                 profile=args.profile)
        _clocked(phase_ooc_unique, report, data, prefix)
        _clocked(phase_ooc_sort, report, data, prefix, profile=args.profile)
        del prefix
        gc.collect()
        _clocked(phase_ooc_repartition, report, data, profile=args.profile)
        del data
        _clocked(phase_ooc_distributed, report, profile=args.profile)
        _clocked(phase_oom_refinement, report, OOM_ROWS)
        _clocked(phase_oneshot_fallback, report)
        gc.collect()
        torch.cuda.empty_cache()
        _clocked(phase_front_door, report)
        gc.collect()
        torch.cuda.empty_cache()
        _clocked(phase_ooc_group, report, profile=args.profile)
        q10, tpch = _clocked(phase_planner, report, profile=args.profile)
        examples_in = {k: tpch.pop(k) for k in ("raw", "q5_oracle")}
        engine = _clocked(phase_durable, report, q10)
        _clocked(phase_serve, report, q10, tpch, engine)
        del q10, tpch
        _clocked(phase_fleet, report, engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        _clocked(phase_examples, report, examples_in)
        del examples_in
        gc.collect()
        torch.cuda.empty_cache()
        _clocked(phase_cylint, report)
        ooc = report["out_of_core"]["sweeps"]
        for r in kernels:
            r["launches_out_of_core"] = [s["launches"].get(r["name"], 0)
                                         for s in ooc]
            r["launches_out_of_core_rest"] = {
                key: report[key]["launches"].get(r["name"], 0)
                for key in ("ooc_groupby", "ooc_unique", "ooc_sort",
                            "ooc_repartition", "ooc_distributed")}
            r["launches_out_of_core_rest"]["oneshot_fallback"] = sum(
                c["launches"].get(r["name"], 0)
                for c in report["oneshot_fallback"].values())
            r["launches_front_door"] = {
                step: v["launches"].get(r["name"], 0)
                for step, v in report["front_door"]["steps"].items()}
            r["launches_ooc_group"] = report["ooc_group"]["launches"].get(
                r["name"], 0)
            r["launches_planner"] = {
                f"{q}_{arm}": report["planner"][q][arm]["launches"].get(
                    r["name"], 0)
                for q in ("q10", "q5") for arm in ("planned", "eager")}
            r["launches_durable"] = {
                step: v.get(r["name"], 0) for step, v in
                report["durable"]["launches_durable"].items()}
            r["launches_serve"] = {
                step: v.get(r["name"], 0) for step, v in
                report["serve"]["launches_serve"].items()}
            r["launches_fleet"] = {
                part: v.get(r["name"], 0) for part, v in
                report["fleet"]["launches_fleet"].items()}
            r["launches_examples"] = {
                name: v["launches"].get(r["name"], 0) for name, v in
                report["examples"]["drivers"].items()}
            r["launches_cylint"] = {
                name: v["launches"].get(r["name"], 0) for name, v in
                report["cylint"]["budgets"].items()}
        report["kernels"] = kernels
        report["wall_s"] = time.perf_counter() - t_start
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1, default=str)

    log("[wall] phases: " + ", ".join(
        f"{name[6:]} {secs:.1f} s"
        for name, secs in report["phase_wall_s"].items()))
    log(f"[wall] chip_smoke.py ran {report['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(report["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
