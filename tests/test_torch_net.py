"""The port's net/ layer, the counterpart of ``tests/test_net.py``
(reference: python/test/test_txrequest.py, test_channel.py object-shape
tests + a functional byte all-to-all check), and ``exchange_bytes``
against the JAX package's on the same buffers."""
import numpy as np
import pytest


@pytest.fixture()
def pctx4():
    """The port's 4-shard mesh on the CPU."""
    from cylon_tpu_torch import CylonContext, MeshConfig

    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


def test_txrequest_shape():
    from cylon_tpu_torch.net import TxRequest

    header = np.array([1, 2, 3, 4], dtype=np.int32)
    buf = np.arange(8, dtype=np.float64)
    tx = TxRequest(10, buf, 8, header, header.shape[0])
    assert tx.target == 10
    assert tx.buf.shape == buf.shape and tx.buf.dtype == buf.dtype
    assert tx.header.shape == header.shape
    assert tx.headerLength == 4
    assert tx.length == 8
    assert "target=10" in tx.to_string("double", 32)


def test_txrequest_header_cap():
    from cylon_tpu_torch.net import TxRequest
    from cylon_tpu_torch.status import CylonError

    with pytest.raises(CylonError):
        TxRequest(0, None, 0, np.zeros(7, np.int32), 7)


def test_channel_callback_imports():
    from cylon_tpu_torch.net import (Allocator, Buffer, Channel,  # noqa: F401
                               ChannelReceiveCallback, ChannelSendCallback,
                               DefaultAllocator)

    buf = DefaultAllocator().Allocate(16)
    assert buf.GetLength() == 16
    assert buf.GetByteBuffer().dtype == np.uint8


def test_control_request_retries_transient_reset_once():
    """A mid-verb reset (the peer accepted, then tore the connection
    down before replying) gets ONE classified retry on a fresh
    connection; a healthy second accept serves the reply.  Refused
    connections (nobody listening) are NOT retried here — the agent's
    failure accounting owns those."""
    import json
    import socket
    import threading

    from cylon_tpu_torch.net import control
    from cylon_tpu_torch.obs import metrics as obs_metrics

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    addr = srv.getsockname()[:2]

    def serve():
        # first connection: accept and slam shut mid-verb
        conn, _ = srv.accept()
        conn.close()
        # second connection: a proper reply
        conn, _ = srv.accept()
        with conn:
            conn.recv(4096)
            conn.sendall(json.dumps({"ok": True, "n": 7}).encode() + b"\n")

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    before = obs_metrics.counter_value("control.retries")
    try:
        resp = control.request(addr, {"cmd": "ping"}, timeout=5.0)
    finally:
        srv.close()
    t.join(5)
    assert resp == {"ok": True, "n": 7}
    assert obs_metrics.counter_value("control.retries") == before + 1


def test_control_request_reset_twice_raises_oserror():
    """The retry budget is one: a peer that resets BOTH attempts still
    surfaces the raw OSError for the caller to classify."""
    import socket
    import threading

    from cylon_tpu_torch.net import control

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    addr = srv.getsockname()[:2]

    def serve():
        for _ in range(2):
            conn, _ = srv.accept()
            conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        with pytest.raises(OSError):
            control.request(addr, {"cmd": "ping"}, timeout=5.0)
    finally:
        srv.close()
    t.join(5)


def test_byte_all_to_all_local():
    """Reference semantics: insert per-target buffers, finish, poll
    isComplete; receive callbacks fire with source + bytes + headers
    (net/ops/all_to_all.cpp fin handshake)."""
    from cylon_tpu_torch.net import AllToAll, ReceiveCallback

    world = 4

    class Collector(ReceiveCallback):
        def __init__(self):
            self.data = {}
            self.headers = {}

        def onReceive(self, source, buffer, length):
            self.data[source] = bytes(buffer.GetByteBuffer()[:length])
            return True

        def onReceiveHeader(self, source, finished, header, length):
            if not finished and header is not None:
                self.headers[source] = list(header[:length])
            return True

    class FakeCtx:
        def __init__(self, rank):
            self._rank = rank

        def GetRank(self):
            return self._rank

    fabric = {}
    ranks = list(range(world))
    collectors = [Collector() for _ in ranks]
    ops = [AllToAll(FakeCtx(r), ranks, ranks, 0, collectors[r], fabric=fabric)
           for r in ranks]
    for r, op in enumerate(ops):
        for t in ranks:
            payload = np.frombuffer(f"r{r}->t{t}".encode(), np.uint8)
            op.insert(payload, len(payload), t,
                      np.array([r, t, 99], np.int32))
        op.finish()
    # progress every rank each round (generator short-circuit would starve
    # the later ranks' sends, as with the reference's progress loops)
    for _ in range(100):
        if all([op.isComplete() for op in ops]):
            break
    else:
        raise AssertionError("all-to-all did not complete")
    for t in ranks:
        for r in ranks:
            assert collectors[t].data[r] == f"r{r}->t{t}".encode()
            assert collectors[t].headers[r] == [r, t, 99]


def test_exchange_bytes_device(pctx4):
    from cylon_tpu_torch.net import exchange_bytes

    world = 4
    per_target = [[f"{r}:{t}".encode() * (t + 1) for t in range(world)]
                  for r in range(world)]
    received = exchange_bytes(pctx4, per_target)
    for r in range(world):
        for s in range(world):
            assert bytes(received[r][s]) == f"{s}:{r}".encode() * (r + 1)


def test_exchange_bytes_ndarray_views(pctx4):
    """Non-uint8 and non-contiguous ndarray buffers serialize by nbytes."""
    import numpy as np

    from cylon_tpu_torch.net import exchange_bytes

    world = 4
    base = np.arange(40, dtype=np.int32).reshape(5, 8)
    per_target = [[base[:, ::2][: r + 1] for t in range(world)]
                  for r in range(world)]
    received = exchange_bytes(pctx4, per_target)
    for r in range(world):
        for s in range(world):
            expect = np.ascontiguousarray(base[:, ::2][: s + 1])
            got = np.frombuffer(bytes(received[r][s]), np.int32)
            assert np.array_equal(got, expect.ravel())


def test_exchange_bytes_matches_reference(pctx4, ctx4):
    """The same ragged buffers through the reference's padded
    ``lax.all_to_all`` and the port's exact-size exchange: every
    received buffer byte for byte."""
    from cylon_tpu.net import exchange_bytes as ref_exchange
    from cylon_tpu_torch.net import exchange_bytes

    rng = np.random.default_rng(5)
    world = 4
    per_target = [[rng.integers(0, 256, int(rng.integers(0, 40)))
                   .astype(np.uint8) for _ in range(world)]
                  for _ in range(world)]
    got = exchange_bytes(pctx4, per_target)
    want = ref_exchange(ctx4, per_target)
    for r in range(world):
        for s in range(world):
            assert bytes(got[r][s]) == bytes(want[r][s])


def test_exchange_bytes_refuses_a_short_send_list(pctx4):
    from cylon_tpu_torch.net import exchange_bytes
    from cylon_tpu_torch.status import Code, CylonError

    with pytest.raises(CylonError) as ei:
        exchange_bytes(pctx4, [[b""] * 4] * 3)
    assert ei.value.code == Code.Invalid
    with pytest.raises(CylonError):
        exchange_bytes(pctx4, [[b""] * 4] * 3 + [[b""] * 3])


def test_net_reexports_the_context_configs():
    """``CommType``/``CommConfig``/``LocalConfig`` are the context's, and
    ``MeshConfig`` stands where the reference re-exports ``TPUConfig``."""
    from cylon_tpu_torch import context, net

    assert net.CommType is context.CommType
    assert net.LocalConfig is context.LocalConfig
    assert net.MeshConfig is context.MeshConfig
    assert net.LocalConfig().comm_type() == net.CommType.LOCAL
