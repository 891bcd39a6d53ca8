"""Row -> target-shard assignment by key hash.

The port of ``cylon_tpu/parallel/partition.py:40 hash_targets``.  The
reference hashes with the Pallas murmur3 kernel on a TPU and with a jnp
hash elsewhere; the port hashes with murmur3 on every device (the CUDA
kernel on the card, its plain version on the CPU), so it places rows as
the reference does on a TPU.  ``range_targets`` and ``column_stats`` are
not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..column import Column
from ..ops import compact, hash_kernels


def hash_targets(cols: Sequence[Column], count, key_idx: Sequence[int],
                 world: int) -> torch.Tensor:
    """int32[cap] target shard per row; padding rows (``row >= count``) get
    ``world``, a bucket nothing is sent to."""
    _, t = hash_kernels.hash_partition([cols[i] for i in key_idx], world)
    live = compact.live_mask(t.shape[0], count, t.device)
    return torch.where(live, t, torch.full((), world, dtype=torch.int32,
                                           device=t.device))
