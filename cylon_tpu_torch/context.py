"""Execution context: a mesh of shards, in one process or over a
``torch.distributed`` process group.

The port of ``cylon_tpu/context.py:103 CylonContext`` (reference:
cpp/src/cylon/ctx/cylon_context.hpp:29-146).  A context holds ``world``
shards.  Without ``num_processes`` it is single controller, as the JAX
package is on one host: one process holds every shard, shard ``i`` lives
on ``ctx.devices[i]``, the shards go round-robin over the devices the
config names (several may share one card), and the collectives
(``parallel/collectives.py``) move tensors between the shards' devices.

With ``num_processes`` (``MeshConfig``'s ``coordinator_address``,
``num_processes``, ``process_id``, the counterpart of the reference's
``jax.distributed.initialize`` world, ``cylon_tpu/context.py:124-140``)
the context first joins a process group, gloo for CPU shards and NCCL for
CUDA shards.  Each process then holds ``L`` local shards, and process
``p`` holds global shards ``[p*L, (p+1)*L)``: ``ctx.devices`` lists the
local shards' devices, ``ctx.shard_ids`` their global ids,
``GetWorldSize()`` is ``L * num_processes`` and ``GetRank()`` the process
rank.  Each collective runs its in-process part over the local shards and
crosses processes with one torch collective (``ctx.group``).  A group of
one process (``num_processes=1``) is how one card runs the group path.

An ``ElasticConfig`` context (``cylon_tpu/context.py:80``) is one member
of an elastic gang: the process keeps its own shards (by default one on
the current CUDA card) and joins the gang's coordinator
(``elastic.py``) once they exist; ``GetRank`` is then the gang rank and
``GetNeighbours`` the live members.
"""
from __future__ import annotations

import datetime
import enum
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from .column import resolve_device
from .status import Code, CylonError

#: seconds a process group's rendezvous and collectives may wait before
#: they raise (``MeshConfig(timeout_s=)``)
DEFAULT_TIMEOUT_S = 300.0


class CommType(enum.IntEnum):
    """Communication backends (``cylon_tpu/context.py:30``)."""

    LOCAL = 0
    MESH = 1  # a mesh of shards: in one process, or over a process group


class CommConfig:
    """Base communicator config (reference: net/comm_config.hpp)."""

    def comm_type(self) -> CommType:
        raise NotImplementedError


class LocalConfig(CommConfig):
    def comm_type(self) -> CommType:
        return CommType.LOCAL


class MeshConfig(CommConfig):
    """Distributed config, the counterpart of ``TPUConfig``
    (``cylon_tpu/context.py:52``).

    devices:    the devices this process's shards go round-robin over;
                default, the CUDA devices ``local_device_ids`` names, else
                every visible CUDA device (pass ``["cpu"]`` to run on the
                CPU).
    world_size: the number of shards this process holds; default, one per
                device.

    Across processes (the reference's multi-host world): pass
    ``coordinator_address`` (``host:port`` of process 0's rendezvous),
    ``num_processes`` and ``process_id``; every process must hold the same
    number of shards.  ``local_device_ids`` picks this process's CUDA
    devices (one NCCL rank per card: ``[local_rank]``).  The backend
    follows the shards' devices: gloo on the CPU, NCCL on CUDA.
    ``timeout_s`` bounds the rendezvous and every collective."""

    def __init__(self, devices: Optional[Sequence] = None,
                 world_size: Optional[int] = None,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 local_device_ids: Optional[Sequence[int]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.devices = devices
        self.world_size = world_size
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        self.process_id = process_id
        self.local_device_ids = local_device_ids
        self.timeout_s = timeout_s

    def comm_type(self) -> CommType:
        return CommType.MESH


class ElasticConfig(MeshConfig):
    """Config for one member of an elastic gang (``cylon_tpu/context.py:
    80``): each process drives its own shards while a TCP control plane
    (``elastic.py``: a coordinator and one agent per process, heartbeats,
    epoch-numbered membership) tracks who is alive.  On a membership
    change the gang re-forms at the shrunken world and the durable
    journal carries completed work across the shrink.

    ``rank``: this process's gang rank; ``coordinator``: ``host:port`` of
    the running `elastic.Coordinator` (default: the
    ``CYLON_TPU_ELASTIC_COORD`` knob).  ``devices``/``world_size`` set
    this process's shards as on `MeshConfig`; with neither, one shard on
    the current CUDA card."""

    def __init__(self, rank: int, coordinator: Optional[str] = None,
                 devices: Optional[Sequence] = None,
                 world_size: Optional[int] = None):
        super().__init__(devices=devices, world_size=world_size)
        self.rank = int(rank)
        self.coordinator = coordinator


@dataclass(frozen=True)
class Group:
    """This process's place in the default ``torch.distributed`` group:
    its ``rank`` of ``size`` processes, the ``backend`` and the ``device``
    its collectives run on."""

    rank: int
    size: int
    backend: str
    device: torch.device


def _visible_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise CylonError(Code.Invalid,
                         "no CUDA device available; pass devices=['cpu'] to "
                         "run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _base_devices(cfg: MeshConfig) -> List[torch.device]:
    if cfg.devices is not None:
        return [torch.device(d) for d in cfg.devices]
    if isinstance(cfg, ElasticConfig) and cfg.local_device_ids is None:
        _visible_cuda_devices()  # one member per card: the current one
        return [torch.device("cuda", torch.cuda.current_device())]
    if cfg.local_device_ids is not None:
        _visible_cuda_devices()
        return [torch.device("cuda", int(i)) for i in cfg.local_device_ids]
    return _visible_cuda_devices()


def _backend_of(devices: Sequence[torch.device]) -> str:
    """gloo for CPU shards, NCCL for CUDA shards."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"}:
        return "nccl"
    raise CylonError(Code.Invalid, f"a process group needs the shards on one "
                     f"kind of device, got {sorted(kinds)}")


def _join_group(cfg: MeshConfig, devices: Sequence[torch.device]):
    """Join the default process group (or check the one already formed)
    and agree on the shard count: every process must hold as many.
    Returns (the Group, whether this call formed the process group)."""
    import torch.distributed as dist

    nprocs = int(cfg.num_processes)
    rank = 0 if cfg.process_id is None else int(cfg.process_id)
    if nprocs < 1 or not 0 <= rank < nprocs:
        raise CylonError(Code.Invalid, f"process_id {rank} outside "
                         f"num_processes {nprocs}")
    backend = _backend_of(devices)
    device = devices[0]
    if backend == "nccl":
        if device.index is None:  # "cuda": the current card, by its index
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:  # CUDA shards never ride gloo by host copies
            raise CylonError(Code.Invalid,
                             f"the process group rides {have}, but the shards "
                             f"are on {device.type}: they need {backend}")
        if (dist.get_world_size(), dist.get_rank()) != (nprocs, rank):
            raise CylonError(Code.Invalid, "the formed process group is rank "
                             f"{dist.get_rank()} of {dist.get_world_size()}, "
                             f"not {rank} of {nprocs}")
        owned = False
    else:
        if cfg.coordinator_address is None and nprocs > 1:
            raise CylonError(Code.Invalid, "num_processes > 1 needs a "
                             "coordinator_address (host:port)")
        addr = cfg.coordinator_address or _loopback_address()
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}", rank=rank,
            world_size=nprocs,
            timeout=datetime.timedelta(seconds=float(cfg.timeout_s)))
        owned = True
    group = Group(rank, nprocs, backend, device)
    counts = torch.tensor([len(devices)], dtype=torch.int64, device=device)
    seen = [torch.empty_like(counts) for _ in range(nprocs)]
    dist.all_gather(seen, counts)
    seen_l = [int(c) for c in seen]
    if len(set(seen_l)) != 1:
        if owned:
            dist.destroy_process_group()
        raise CylonError(Code.Invalid, f"processes hold different shard "
                         f"counts: {seen_l}")
    return group, owned


def _loopback_address() -> str:
    """``127.0.0.1:<a free port>`` for a one-process group."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


class CylonContext:
    """Entry point holding the mesh: ``Init`` / ``InitDistributed`` /
    ``GetRank`` / ``GetWorldSize`` / ``GetNeighbours`` / ``AddConfig`` /
    ``GetConfig`` / ``GetNextSequence`` / ``Barrier`` / ``Finalize``, as in
    the reference surface (ctx/cylon_context.hpp:29-146)."""

    def __init__(self, config: Optional[CommConfig] = None,
                 distributed: bool = False, device=None):
        self._config: Dict[str, str] = {}
        self._sequence = 0
        self._lock = threading.Lock()
        self.distributed = distributed
        self.group: Optional[Group] = None
        self._owns_group = False
        self._elastic_agent = None
        if not distributed:
            self.devices = [resolve_device(device)]
            self.shard_ids = [0]
            return
        cfg = config if isinstance(config, MeshConfig) else MeshConfig()
        base = _base_devices(cfg)
        if not base:
            raise CylonError(Code.Invalid, "MeshConfig names no devices")
        world = len(base) if cfg.world_size is None else int(cfg.world_size)
        if world < 1:
            raise CylonError(Code.Invalid,
                             f"world_size must be >= 1, got {world}")
        self.devices = [base[i % len(base)] for i in range(world)]
        if cfg.num_processes is not None:
            self.group, self._owns_group = _join_group(cfg, self.devices)
        first = self.group.rank * world if self.group else 0
        self.shard_ids = list(range(first, first + world))
        if isinstance(cfg, ElasticConfig):
            # join the gang AFTER the shards exist: membership is a
            # control-plane fact over per-process contexts (the gang
            # re-forms, a context never reshapes)
            from . import elastic

            self._elastic_agent = elastic.connect(cfg.rank, cfg.coordinator)
        else:
            # the environment's opt-in (CYLON_TPU_ELASTIC=1 and
            # CYLON_TPU_ELASTIC_COORD): a distributed context joins the
            # gang at its process id, with no code change
            from . import elastic

            if elastic.elastic_enabled():
                rank = cfg.process_id if cfg.process_id is not None else 0
                self._elastic_agent = elastic.connect(rank)

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

    # -- identity ----------------------------------------------------------
    def GetRank(self) -> int:
        """The process rank: the gang rank under an elastic agent, else
        the group rank, 0 when one process drives every shard."""
        if self._elastic_agent is not None:
            return self._elastic_agent.rank
        return self.group.rank if self.group else 0

    def elastic_agent(self):
        """The `elastic.Agent` this context joined the gang with, or None
        for a fixed-world context."""
        return self._elastic_agent

    def num_processes(self) -> int:
        return self.group.size if self.group else 1

    def GetWorldSize(self) -> int:
        """The global shard count, over every process."""
        return len(self.devices) * self.num_processes()

    @property
    def world_size(self) -> int:
        return self.GetWorldSize()

    def GetNeighbours(self, include_self: bool = False) -> List[int]:
        """The other ranks: under an elastic agent the LIVE gang members
        (the shard count is per process and says nothing about peers),
        else the other ranks of the world."""
        if self._elastic_agent is not None:
            return [m for m in self._elastic_agent.members
                    if include_self or m != self._elastic_agent.rank]
        return [i for i in range(self.GetWorldSize())
                if include_self or i != self.GetRank()]

    def is_distributed(self) -> bool:
        return self.distributed

    # -- config k/v map (cylon_context.cpp:60-69) --------------------------
    def AddConfig(self, key: str, value: str) -> None:
        self._config[key] = value

    def GetConfig(self, key: str, default: str = "") -> str:
        return self._config.get(key, default)

    def GetNextSequence(self) -> int:
        """A per-context sequence number, the reference's per-operation
        edge tag; collectives are ordered by program order, so nothing
        reads it (kept for the surface, locked as the reference's)."""
        with self._lock:
            self._sequence += 1
            return self._sequence

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
        """True when the mesh spans several processes (a group of more
        than one)."""
        return self.group is not None and self.group.size > 1

    def collective_retry_policy(self):
        """Policy for retrying a whole collective (shuffle exchange,
        broadcast gather, distributed per-pass join).  Safe only when ONE
        process drives every shard: re-entering the collective from one
        process of a multi-process mesh would start an exchange the peers
        never join.  Multi-process runs therefore get a no-retry policy
        and the failure surfaces at once."""
        from .resilience import RetryPolicy

        if self.distributed and self.multi_process():
            base = self.retry_policy()
            return RetryPolicy(max_retries=0, base_s=base.base_s,
                               max_s=base.max_s)
        return self.retry_policy()

    def Barrier(self) -> None:
        """Wait until every shard's device has finished its queued work,
        then, over a group, until every process has reached this point."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        import torch.distributed as dist

        if self.group is not None and dist.is_initialized():
            if self.group.backend == "nccl":
                dist.barrier(device_ids=[self.group.device.index])
            else:
                dist.barrier()

    def Finalize(self) -> None:
        """Wait for the devices (and the other processes), then leave the
        process group this context formed and the elastic gang."""
        self.Barrier()
        if self._elastic_agent is not None:
            self._elastic_agent.leave()
        if self._owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._owns_group = False

    def __repr__(self) -> str:
        kind = "distributed" if self.distributed else "local"
        devs = sorted({str(d) for d in self.devices})
        procs = (f", rank={self.group.rank}/{self.group.size} "
                 f"{self.group.backend}" if self.group else "")
        return (f"CylonContext({kind}, world_size={self.GetWorldSize()}, "
                f"devices={devs}{procs})")
