"""Shared advisory lease over a journal root: the one implementation
behind the GC sweep (`durable.gc_journal`), the integrity scrubber
(`durable_sync.scrub_once`) and the offline checker
(``tools/journal_fsck.py``, which loads the JAX package's copy of this
file by path).  A copy of ``cylon_tpu/durable_lease.py``: the lock file's
name and JSON body are the same bytes, so a walker of either package
excludes a walker of the other on one root.

Stdlib only (no numpy, no obs, no package siblings); callers that want
counters pass ``on_busy``.

Semantics: O_CREAT|O_EXCL on ``<root>/GC_LOCK`` with pid + wall-clock
inside for operators; a holder younger than the TTL excludes us; a stale
lease (crashed holder) is broken by an atomic rewrite.  Two breakers
racing the rewrite is acceptable for an ADVISORY lease: the per-victim
manifest-mtime re-read under the lease is what protects correctness, the
lease only serializes the common case.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Callable, Iterator, Optional

log = logging.getLogger("cylon_tpu_torch")

#: advisory cross-process lease file name (journal root)
GC_LOCK = "GC_LOCK"

#: a holder younger than this excludes every other walker
LEASE_TTL_S = 30.0


def acquire_lease(root: str, ttl_s: float = LEASE_TTL_S,
                  on_busy: Optional[Callable[[], None]] = None,
                  ) -> Optional[str]:
    """Acquire the advisory walker lease on ``root``; returns the lease
    path, or None when another walker holds a lease younger than
    ``ttl_s`` (``on_busy`` is invoked exactly then — the hook where
    durable.py counts ``durable.gc_lease_busy``)."""
    path = os.path.join(root, GC_LOCK)
    payload = json.dumps({"pid": os.getpid(), "ts": time.time()}) + "\n"
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        try:
            age = time.time() - os.path.getmtime(path)
        except OSError:
            return None  # holder released between exists and stat
        if age < ttl_s:
            if on_busy is not None:
                on_busy()
            return None
        tmp = path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(payload)
            os.replace(tmp, path)
        except OSError:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            return None
        log.warning("durable: broke stale GC lease at %s (age %.1fs)",
                    path, age)
        return path
    except OSError:
        return None
    try:
        os.write(fd, payload.encode())
    finally:
        os.close(fd)
    return path


def release_lease(path: str) -> None:
    with contextlib.suppress(OSError):
        os.remove(path)


@contextlib.contextmanager
def lease(root: str, ttl_s: float = LEASE_TTL_S,
          on_busy: Optional[Callable[[], None]] = None) -> Iterator[Optional[str]]:
    """Context manager form: yields the lease path (held for the body)
    or None when busy — the body must check and bail without touching
    the root destructively."""
    path = acquire_lease(root, ttl_s=ttl_s, on_busy=on_busy)
    try:
        yield path
    finally:
        if path is not None:
            release_lease(path)
