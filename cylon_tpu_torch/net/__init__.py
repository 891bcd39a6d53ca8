"""Communication abstractions: the channel surface and the byte exchange.

The port of ``cylon_tpu/net/__init__.py`` (reference:
cpp/src/cylon/net/: Communicator/CommConfig, Channel with per-peer send
and receive state machines over MPI_Isend/Irecv, Buffer/Allocator,
TxRequest descriptors, and the byte-level N x N AllToAll with its fin
handshake — net/communicator.hpp:24-37, net/channel.hpp:30-90,
net/buffer.hpp:25-61, net/TxRequest.hpp:21-39, net/ops/all_to_all.hpp:
27-166).  Those exist because MPI point-to-point needs explicit progress
and pre-allocation; here the data path is the collectives of
``parallel/collectives.py``, whose program order subsumes the state
machines.

This package keeps the abstraction surface (python/pycylon/net/
txrequest.pyx:20-50, channel.pyx:26-49, comm_config.pyx, mpi_config.pyx)
with two transports:

- ``LocalChannel``/``AllToAll``: an in-process implementation (the
  reference's CommType.LOCAL) for composing byte-streaming ops and for
  tests;
- ``exchange_bytes``: one exact-size uint8 exchange over the context's
  shards (``collectives.all_to_all``): a device-local copy in one
  process, one ``all_to_all_single`` over a process group.

``control.py`` holds the control plane's one-shot JSON requests over
TCP, which the elastic gang, the query router and the journal's peer
server ride.  ``CommType``, ``CommConfig`` and ``LocalConfig`` are the
context's (``context.py``); ``MeshConfig`` takes the place of the
reference's ``TPUConfig``.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..context import CommType, CommConfig, LocalConfig, MeshConfig  # noqa: F401
from ..status import Code, CylonError

CHANNEL_HEADER_SIZE = 8  # ints: length, fin flag + <=6 user ints
MAX_USER_HEADER = 6      # reference: mpi_channel.hpp:28, channel.hpp:51-60


class TxRequest:
    """Send descriptor: target, byte buffer, <=6-int user header
    (reference: net/TxRequest.hpp:21-39)."""

    def __init__(self, target: int, buf: Optional[np.ndarray] = None,
                 length: int = 0, header: Optional[np.ndarray] = None,
                 header_length: int = 0):
        if header is not None and header_length > MAX_USER_HEADER:
            raise CylonError(Code.Invalid,
                             f"header limited to {MAX_USER_HEADER} ints")
        self.target = target
        self.buf = buf
        self.length = length
        self.header = header
        self.headerLength = header_length

    def to_string(self, data_type: str = "", depth: int = 8) -> str:
        return (f"TxRequest(target={self.target}, length={self.length}, "
                f"header={None if self.header is None else list(self.header[:self.headerLength])}, "
                f"type={data_type}, depth={depth})")


class Buffer:
    """Byte buffer the channel allocates receives into
    (reference: net/buffer.hpp:25-45)."""

    def __init__(self, data: np.ndarray):
        self._data = np.ascontiguousarray(data, dtype=np.uint8)

    def GetByteBuffer(self) -> np.ndarray:
        return self._data

    def GetLength(self) -> int:
        return int(self._data.shape[0])


class Allocator(abc.ABC):
    """reference: net/buffer.hpp:50-61."""

    @abc.abstractmethod
    def Allocate(self, length: int) -> Buffer:
        ...


class DefaultAllocator(Allocator):
    def Allocate(self, length: int) -> Buffer:
        return Buffer(np.zeros((length,), np.uint8))


class ChannelSendCallback(abc.ABC):
    """reference: net/channel.hpp:30-40."""

    @abc.abstractmethod
    def sendComplete(self, request: TxRequest) -> None:
        ...

    def sendFinishComplete(self, request: TxRequest) -> None:
        pass


class ChannelReceiveCallback(abc.ABC):
    """reference: net/channel.hpp:42-49."""

    @abc.abstractmethod
    def receivedData(self, source: int, buffer: Buffer, length: int) -> None:
        ...

    def receivedHeader(self, source: int, fin: bool,
                       header: Optional[np.ndarray], length: int) -> None:
        pass


class Channel(abc.ABC):
    """Nonblocking P2P message channel (reference: net/channel.hpp:51-90).

    The MPI implementation runs per-peer state machines
    (SEND_INIT->LENGTH_POSTED->POSTED->FINISH->DONE, mpi_channel.cpp:30-247)
    progressed by polling; implementations here deliver on ``progress*``
    calls from in-process queues."""

    @abc.abstractmethod
    def init(self, edge: int, receives: Sequence[int], sendIds: Sequence[int],
             rcv: ChannelReceiveCallback, send: ChannelSendCallback,
             alloc: Allocator) -> None:
        ...

    @abc.abstractmethod
    def send(self, request: TxRequest) -> bool:
        ...

    @abc.abstractmethod
    def sendFin(self, request: TxRequest) -> bool:
        ...

    @abc.abstractmethod
    def progressSends(self) -> None:
        ...

    @abc.abstractmethod
    def progressReceives(self) -> None:
        ...

    def close(self) -> None:
        pass


class LocalChannel(Channel):
    """In-process channel: every rank's queue lives in one address space
    (the reference's CommType.LOCAL — single-process world).  A channel
    instance belongs to one rank; a shared ``fabric`` dict keyed by
    (edge, target) carries messages between instances."""

    _PENDING_CAP = 1000  # reference: mpi_channel.cpp:57 queue cap per target

    def __init__(self, rank: int, fabric: Dict):
        self.rank = rank
        self._fabric = fabric
        self._edge = None
        self._rcv_cb: Optional[ChannelReceiveCallback] = None
        self._send_cb: Optional[ChannelSendCallback] = None
        self._alloc: Optional[Allocator] = None
        self._pending: List[TxRequest] = []
        self._fins: List[TxRequest] = []

    def init(self, edge, receives, sendIds, rcv, send, alloc):
        self._edge = edge
        self._rcv_cb = rcv
        self._send_cb = send
        self._alloc = alloc
        for src in receives:
            self._fabric.setdefault((edge, src, self.rank), [])

    def send(self, request: TxRequest) -> bool:
        if len(self._pending) >= self._PENDING_CAP:
            return False
        self._pending.append(request)
        return True

    def sendFin(self, request: TxRequest) -> bool:
        self._fins.append(request)
        return True

    def progressSends(self) -> None:
        for req in self._pending:
            self._fabric.setdefault((self._edge, self.rank, req.target), []) \
                .append(("data", req))
            self._send_cb.sendComplete(req)
        self._pending.clear()
        for req in self._fins:
            self._fabric.setdefault((self._edge, self.rank, req.target), []) \
                .append(("fin", req))
            self._send_cb.sendFinishComplete(req)
        self._fins.clear()

    def progressReceives(self) -> None:
        for (edge, src, dst), queue in list(self._fabric.items()):
            if edge != self._edge or dst != self.rank:
                continue
            while queue:
                kind, req = queue.pop(0)
                if kind == "fin":
                    self._rcv_cb.receivedHeader(src, True, None, 0)
                    continue
                self._rcv_cb.receivedHeader(
                    src, False, req.header, req.headerLength)
                length = req.length
                buf = self._alloc.Allocate(length)
                raw = np.ascontiguousarray(req.buf).view(np.uint8)
                buf.GetByteBuffer()[:length] = raw.ravel()[:length]
                self._rcv_cb.receivedData(src, buf, length)


class ReceiveCallback(abc.ABC):
    """reference: net/ops/all_to_all.hpp:27-52."""

    @abc.abstractmethod
    def onReceive(self, source: int, buffer: Buffer, length: int) -> bool:
        ...

    def onReceiveHeader(self, source: int, finished: bool,
                        header: Optional[np.ndarray], length: int) -> bool:
        return True

    def onSendComplete(self, target: int, buffer, length: int) -> bool:
        return True


class AllToAll(ChannelSendCallback, ChannelReceiveCallback):
    """Byte-level N x N nonblocking all-to-all composed from channels
    (reference: net/ops/all_to_all.hpp:76-166, all_to_all.cpp:26-178):
    per-target insert queues, a fin handshake (finishedSources/
    finishedTargets), and a polled ``isComplete``."""

    def __init__(self, ctx, sources: Sequence[int], targets: Sequence[int],
                 edge_id: int, callback: ReceiveCallback,
                 channel: Optional[Channel] = None,
                 fabric: Optional[Dict] = None,
                 rank: Optional[int] = None):
        # ctx.GetRank() is the PROCESS rank (0 for every in-process mesh,
        # the group rank over a process group); when composing one
        # AllToAll per mesh shard in a single process, pass ``rank``
        # explicitly — shard index and process index are different id
        # spaces
        self.rank = ctx.GetRank() if rank is None else rank
        self.sources = list(sources)
        self.targets = list(targets)
        self.callback = callback
        self.finished = False
        self._finished_sources = set()
        self._finished_targets = set()
        self._alloc = DefaultAllocator()
        self.channel = channel or LocalChannel(
            self.rank, fabric if fabric is not None else {})
        self.channel.init(edge_id, self.sources, self.targets, self, self,
                          self._alloc)

    # -- sender side ----------------------------------------------------
    def insert(self, buffer: np.ndarray, length: int, target: int,
               header: Optional[np.ndarray] = None) -> int:
        if self.finished:
            return -1
        hlen = 0 if header is None else len(header)
        ok = self.channel.send(TxRequest(target, buffer, length, header, hlen))
        return 1 if ok else -1

    def finish(self) -> None:
        self.finished = True
        for target in self.targets:
            self.channel.sendFin(TxRequest(target))

    def isComplete(self) -> bool:
        self.channel.progressSends()
        self.channel.progressReceives()
        return (set(self.sources) <= self._finished_sources
                and self.finished)

    def close(self) -> None:
        self.channel.close()

    # -- channel callbacks ----------------------------------------------
    def sendComplete(self, request: TxRequest) -> None:
        self.callback.onSendComplete(request.target, request.buf,
                                     request.length)

    def sendFinishComplete(self, request: TxRequest) -> None:
        self._finished_targets.add(request.target)

    def receivedData(self, source: int, buffer: Buffer, length: int) -> None:
        self.callback.onReceive(source, buffer, length)

    def receivedHeader(self, source, fin, header, length) -> None:
        if fin:
            self._finished_sources.add(source)
        self.callback.onReceiveHeader(source, fin, header, length)


def exchange_bytes(ctx, per_target: Sequence) -> List[Optional[np.ndarray]]:
    """Byte exchange over the context's shards: one exact-size uint8
    ``collectives.all_to_all`` moves every shard's buffers, the
    counterpart of progressing every channel to completion.

    ``per_target[r][t]``: the bytes global shard ``r`` sends to shard
    ``t`` (one list of ``world`` buffers per shard; bytes or any
    ndarray, sent as its raw bytes).  Returns ``received`` with
    ``received[r][s]`` the bytes shard ``r`` got from shard ``s``.  In
    one process every shard is local.  Over a process group only this
    process's shards' rows of ``per_target`` are read (the others may be
    None), the size matrix is all-gathered first, and the other
    processes' entries of ``received`` are None."""
    import torch

    from ..parallel import collectives

    world = ctx.GetWorldSize()
    if len(per_target) != world:
        raise CylonError(Code.Invalid, "need one send list per rank")
    shards = list(ctx.shard_ids)
    raws = {}
    for r in shards:
        row = per_target[r]
        if row is None or len(row) != world:
            raise CylonError(Code.Invalid,
                             f"shard {r} needs one buffer per rank")
        raws[r] = [np.frombuffer(bytes(b), np.uint8)
                   if not isinstance(b, np.ndarray)
                   else np.ascontiguousarray(b).view(np.uint8).ravel()
                   for b in row]
    local_sizes = np.asarray([[raw.size for raw in raws[r]]
                              for r in shards], np.int64)
    group = ctx.group if ctx.multi_process() else None
    sizes = collectives.process_allgather(local_sizes, group)
    sizes = sizes.reshape(world, world)
    send = [torch.from_numpy(np.concatenate(raws[r]) if world else
                             np.zeros(0, np.uint8)).to(dev)
            for r, dev in zip(shards, ctx.devices)]
    out = [torch.empty(int(sizes[:, r].sum()), dtype=torch.uint8,
                       device=dev) for r, dev in zip(shards, ctx.devices)]
    out = collectives.all_to_all(send, sizes, out, group=group)
    received: List[Optional[list]] = [None] * world
    for r, buf in zip(shards, out):
        host = buf.cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(sizes[:, r])])
        received[r] = [host[offs[s]:offs[s + 1]] for s in range(world)]
    return received
