"""Execution context: an in-process mesh of shards.

The port of ``cylon_tpu/context.py:103 CylonContext`` (reference:
cpp/src/cylon/ctx/cylon_context.hpp:29-146).  The JAX package is single
controller: one process drives a ``jax.sharding.Mesh`` of devices through
``shard_map``, and its tests run that mesh as virtual CPU devices in one
process.  The port keeps that model.  One process holds ``world`` shards;
shard ``i`` lives on ``ctx.devices[i]``, and the shards go round-robin
over the devices the config names, so several shards may share one card.
The collectives (``parallel/collectives.py``) move tensors between the
shards' devices.  A multi-process ``torch.distributed`` backend, the
counterpart of the reference's multi-host ``jax.distributed.initialize``,
is not ported yet.
"""
from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import torch

from .column import resolve_device
from .status import Code, CylonError


class CommType(enum.IntEnum):
    """Communication backends (``cylon_tpu/context.py:30``)."""

    LOCAL = 0
    MESH = 1  # in-process mesh of shards over devices


class CommConfig:
    """Base communicator config (reference: net/comm_config.hpp)."""

    def comm_type(self) -> CommType:
        raise NotImplementedError


class LocalConfig(CommConfig):
    def comm_type(self) -> CommType:
        return CommType.LOCAL


class MeshConfig(CommConfig):
    """Distributed config over an in-process mesh, the counterpart of
    ``TPUConfig`` (``cylon_tpu/context.py:52``).

    devices:    the devices the shards go round-robin over; default, every
                visible CUDA device (pass ``["cpu"]`` to run on the CPU).
    world_size: the number of shards; default, one per device.
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 world_size: Optional[int] = None):
        self.devices = devices
        self.world_size = world_size

    def comm_type(self) -> CommType:
        return CommType.MESH


def _visible_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise CylonError(Code.Invalid,
                         "no CUDA device available; pass devices=['cpu'] to "
                         "run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class CylonContext:
    """Entry point holding the mesh: ``Init`` / ``InitDistributed`` /
    ``GetRank`` / ``GetWorldSize`` / ``Barrier`` / ``Finalize``, as in the
    reference surface."""

    def __init__(self, config: Optional[CommConfig] = None,
                 distributed: bool = False, device=None):
        self.distributed = distributed
        if not distributed:
            self.devices = [resolve_device(device)]
            return
        cfg = config if isinstance(config, MeshConfig) else MeshConfig()
        base = ([torch.device(d) for d in cfg.devices]
                if cfg.devices is not None else _visible_cuda_devices())
        if not base:
            raise CylonError(Code.Invalid, "MeshConfig names no devices")
        world = len(base) if cfg.world_size is None else int(cfg.world_size)
        if world < 1:
            raise CylonError(Code.Invalid,
                             f"world_size must be >= 1, got {world}")
        self.devices = [base[i % len(base)] for i in range(world)]

    @staticmethod
    def Init(device=None) -> "CylonContext":
        """One shard on ``device`` (default: the CUDA card)."""
        return CylonContext(LocalConfig(), distributed=False, device=device)

    @staticmethod
    def InitDistributed(config: CommConfig) -> "CylonContext":
        if config.comm_type() == CommType.LOCAL:
            raise ValueError("Local communication config passed to "
                             "InitDistributed")
        return CylonContext(config, distributed=True)

    def GetRank(self) -> int:
        """0: one process drives every shard (single controller)."""
        return 0

    def GetWorldSize(self) -> int:
        return len(self.devices)

    def is_distributed(self) -> bool:
        return self.distributed

    # -- resilience --------------------------------------------------------
    def retry_policy(self):
        """Transient-failure retry policy for operations on this context.
        Unset contexts re-read the env knobs (CYLON_TPU_RETRY_*) on every
        call so tests and long-lived processes see live values; an
        explicit `set_retry_policy` pins one."""
        policy = getattr(self, "_retry_policy", None)
        if policy is not None:
            return policy
        from .resilience import RetryPolicy

        return RetryPolicy.from_env()

    def set_retry_policy(self, policy) -> None:
        self._retry_policy = policy

    def multi_process(self) -> bool:
        """True when the mesh spans several processes.  Always False: the
        port's contexts are single-process, and a multi-process
        ``torch.distributed`` backend is not ported yet (ROADMAP.md queue
        A, item 8)."""
        return False

    def collective_retry_policy(self):
        """Policy for retrying a whole collective (shuffle exchange,
        broadcast gather, distributed per-pass join).  Safe only when ONE
        process drives every shard: re-entering the collective from one
        process of a multi-process mesh would start an exchange the peers
        never join.  Multi-process runs therefore get a no-retry policy
        and the failure surfaces at once; since ``multi_process`` is
        always False until a multi-process backend exists, every context
        retries under ``retry_policy()`` today."""
        from .resilience import RetryPolicy

        if self.distributed and self.multi_process():
            base = self.retry_policy()
            return RetryPolicy(max_retries=0, base_s=base.base_s,
                               max_s=base.max_s)
        return self.retry_policy()

    def Barrier(self) -> None:
        """Wait until every shard's device has finished its queued work."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def Finalize(self) -> None:
        """Nothing to tear down in one process: waits for the devices."""
        self.Barrier()

    def __repr__(self) -> str:
        kind = "distributed" if self.distributed else "local"
        devs = sorted({str(d) for d in self.devices})
        return (f"CylonContext({kind}, world_size={self.GetWorldSize()}, "
                f"devices={devs})")
