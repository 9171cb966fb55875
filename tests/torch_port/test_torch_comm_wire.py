"""The port's message protocol, framing, multiplexer and tree codec
(``distributed_learning_tpu_torch.comm``) against the JAX package's,
mirroring the codec and protocol parts of ``tests/test_comm.py``.

Every message packs to the reference's bytes; a port ``FramedStream``
and a reference ``FramedStream`` exchange frames over loopback TCP in
both directions; the torch ``tree_to_flat`` of ``convert.py``-converted
parameters equals the reference's ``tree_to_flat`` bit for bit.
"""

import asyncio
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_learning_tpu.comm import framing as r_framing
from distributed_learning_tpu.comm import protocol as r_protocol
from distributed_learning_tpu.comm import pytree_codec as r_pytree
from distributed_learning_tpu.comm import tensor_codec as r_tc
from distributed_learning_tpu.comm import top_k_compressor as r_top_k_compressor
import distributed_learning_tpu_torch.comm as p_comm
from distributed_learning_tpu_torch import convert
from distributed_learning_tpu_torch.comm import framing as p_framing
from distributed_learning_tpu_torch.comm import protocol as p_protocol
from distributed_learning_tpu_torch.comm import pytree_codec as p_pytree
from distributed_learning_tpu_torch.comm import tensor_codec as p_tc
from distributed_learning_tpu_torch.comm.multiplexer import StreamMultiplexer
from distributed_learning_tpu_torch.models import WideResNet
from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry

_SPARSE = np.array([0, 0, 2.5, 0, -1.0, 0], np.float32)
_BUCKETS = (("float32", ((0, 4),)), ("bfloat16", ((4, 2),)))


def _messages(P):
    """One message of every registered type (and the variants of
    tests/test_comm.py), built from module ``P``."""
    trace = P.TraceContext(run_id=3, origin="a", seq=11, t_wall=1.25)
    return [
        P.Register(token="a", host="1.2.3.4", port=900),
        P.Ok(info="hi"),
        P.ErrorException(message="boom"),
        P.NeighborhoodData(self_weight=0.5, convergence_eps=1e-5,
                           neighbors=[P.Neighbor("b", "h", 1, 0.25),
                                      P.Neighbor("c", "h2", 2, 0.25)]),
        P.NewRoundRequest(weight=3.0),
        P.NewRoundNotification(round_id=7, mean_weight=2.0),
        P.ValueRequest(round_id=7, iteration=3),
        P.ValueResponse(round_id=7, iteration=3, value=np.ones(4, np.float32)),
        P.ValueResponse(round_id=7, iteration=4, value=np.linspace(-1, 1, 9, dtype=np.float32),
                        bf16_wire=True, trace=trace),
        P.ValueResponseSparse(round_id=7, iteration=3, value=_SPARSE),
        P.ValueResponseFusedSparse(round_id=7, iteration=3, value=_SPARSE, buckets=_BUCKETS),
        P.ValueResponseFusedSparse(round_id=7, iteration=5, value=_SPARSE, buckets=_BUCKETS,
                                   int8_wire=True, trace=trace),
        P.Converged(round_id=7, iteration=3),
        P.NotConverged(round_id=7, iteration=3),
        P.Done(round_id=7),
        P.Done(round_id=8, aborted=True),
        P.Done(round_id=9, deadline=True),
        P.Shutdown(reason="bye"),
        P.Telemetry(token="a", payload={"loss": 0.5, "n": 3}),
        P.AsyncValue(round_id=4, generation=2, staleness=1, value=np.arange(6, dtype=np.float32)),
        P.AsyncValue(round_id=5, generation=2, value=_SPARSE, kind=1),
        P.AsyncValue(round_id=6, generation=3, value=_SPARSE, kind=2, buckets=_BUCKETS,
                     trace=trace),
        P.AsyncPoke(round_id=5, generation=2),
        P.AsyncPoke(round_id=6, generation=2, trace=trace),
    ]


def _same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f, v in vars(b).items():
        got = getattr(a, f)
        if f in ("bf16_wire", "int8_wire", "buckets"):  # encode-side hints
            continue
        if isinstance(v, np.ndarray) or hasattr(v, "densify"):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(v))
        elif f == "neighbors":
            assert [vars(n) for n in got] == [vars(n) for n in v]
        elif f == "trace":
            assert (None if got is None else vars(got)) == (None if v is None else vars(v))
        else:
            assert got == v, (b, f)


def test_every_message_packs_to_the_reference_bytes_and_round_trips():
    port, ref = _messages(p_protocol), _messages(r_protocol)
    assert {type(m).TYPE_CODE for m in port} == set(p_protocol._REGISTRY)
    assert ({c: k.__name__ for c, k in p_protocol._REGISTRY.items()}
            == {c: k.__name__ for c, k in r_protocol._REGISTRY.items()})
    for pm, rm in zip(port, ref):
        code, body = p_protocol.pack_message(pm)
        assert (code, body) == r_protocol.pack_message(rm), type(pm).__name__
        out = p_protocol.unpack_message(code, body)
        _same_fields(out, r_protocol.unpack_message(code, body))
        if not (getattr(pm, "bf16_wire", False) or getattr(pm, "int8_wire", False)):
            _same_fields(out, pm)  # lossless messages round-trip exactly


def test_obs_payload_names_come_from_the_port_obs_layer():
    from distributed_learning_tpu_torch.obs import aggregate

    for name in ("OBS_PAYLOAD_KIND", "OBS_PAYLOAD_VERSION", "OBS_PAYLOAD_SECTIONS"):
        assert getattr(p_protocol, name) is getattr(aggregate, name)
        assert getattr(p_protocol, name) == getattr(r_protocol, name)
    assert p_protocol.is_obs_payload is aggregate.is_obs_payload


# --------------------------------------------------------------------- #
# Framing over loopback TCP, port <-> reference                         #
# --------------------------------------------------------------------- #
async def _pair(server_mod, client_mod):
    """A connected (server-side stream, client-side stream) pair on
    127.0.0.1: the server's stream from ``server_mod``, the client's from
    ``client_mod``."""
    accepted = asyncio.get_running_loop().create_future()

    async def handle(reader, writer):
        accepted.set_result(server_mod.FramedStream(reader, writer))

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    client = await client_mod.open_framed_connection("127.0.0.1", port)
    return server, await asyncio.wait_for(accepted, 10), client


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_port_and_reference_framed_streams_exchange_frames(direction):
    send_mod, recv_mod = ((p_framing, r_framing) if direction == "port_to_reference"
                          else (r_framing, p_framing))
    send_proto = p_protocol if send_mod is p_framing else r_protocol
    recv_proto = r_protocol if send_mod is p_framing else p_protocol

    async def main():
        server, receiver, sender = await _pair(recv_mod, send_mod)
        try:
            sent = _messages(send_proto)
            for msg in sent:
                await sender.send(msg)
            for msg, want in zip(sent, _messages(recv_proto)):
                got = await asyncio.wait_for(receiver.recv(), 10)
                _same_fields(got, recv_proto.unpack_message(*recv_proto.pack_message(want)))
            # The reply direction on the same connection.
            await receiver.send(recv_proto.Ok(info="ack"))
            reply = await asyncio.wait_for(sender.recv(), 10)
            assert reply.info == "ack"
            assert sender.bytes_sent == receiver.bytes_received
            assert sender.frames_sent == receiver.frames_received == len(sent)
            # A torn frame: one flipped body byte is a FrameError there.
            code, body = send_proto.pack_message(send_proto.Ok(info="x" * 16))
            header = struct.pack("<IBBH", len(body), p_framing.WIRE_VERSION, code, 0)
            crc = struct.pack("<I", p_tc.native.crc32(body))
            bad = bytearray(body)
            bad[5] ^= 0x01
            sender.writer.write(header + bytes(bad) + crc)
            await sender.writer.drain()
            with pytest.raises(recv_mod.FrameError, match="checksum"):
                await asyncio.wait_for(receiver.recv(), 10)
            with pytest.raises(recv_mod.FrameTimeout):
                await receiver.recv(timeout=0.05)
        finally:
            sender.close()
            receiver.close()
            server.close()
            await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_send_rejects_oversized_frame_and_counts_bytes():
    async def main():
        server, receiver, sender = await _pair(p_framing, p_framing)
        reg = MetricsRegistry()
        try:
            with use_registry(reg):
                await sender.send(p_protocol.Ok(info="hi"))
                await asyncio.wait_for(receiver.recv(), 10)
            counters = reg.snapshot()["counters"]
            assert counters["comm.frames_out"] == counters["comm.frames_in"] == 1
            assert counters["comm.bytes_framed_out"] == sender.bytes_sent
        finally:
            sender.close()
            receiver.close()
            server.close()
            await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 30))
    assert p_framing.MAX_FRAME == r_framing.MAX_FRAME


def test_stream_multiplexer_yields_each_peer_drops_codec_errors_and_reports_death():
    """Three loopback peers behind one ``StreamMultiplexer``: every frame
    arrives under its token; a checksum-clean frame whose fused body is
    corrupt is dropped and counted (``comm.frames_rejected``), the peer
    kept; a closed peer yields ``(token, None, stream)`` once."""
    async def main():
        pairs = [await _pair(p_framing, p_framing) for _ in range(3)]
        mux = StreamMultiplexer({t: rx for t, (_, rx, _) in enumerate(pairs)})
        reg = MetricsRegistry()
        try:
            for t, (_, _, tx) in enumerate(pairs):
                await tx.send(p_protocol.ValueRequest(round_id=t, iteration=t))
            seen = {}
            with use_registry(reg):
                for _ in range(3):
                    token, msg, _stream = await asyncio.wait_for(mux.__anext__(), 10)
                    seen[token] = msg.round_id
                assert seen == {0: 0, 1: 1, 2: 2}
                good = p_protocol.ValueResponseFusedSparse(round_id=1, iteration=0,
                                                           value=_SPARSE, buckets=_BUCKETS)
                code, body = p_protocol.pack_message(good)
                body = bytearray(body)
                body[-10] ^= 0x40  # inside the fused frame: its own crc rejects it
                tx = pairs[1][2]
                header = struct.pack("<IBBH", len(body), p_framing.WIRE_VERSION, code, 0)
                tx.writer.write(header + bytes(body) + struct.pack("<I", p_tc.native.crc32(
                    bytes(body))))
                await tx.send(good)
                token, msg, _ = await asyncio.wait_for(mux.__anext__(), 10)
                assert token == 1 and isinstance(msg.value, p_tc.FusedFrame)
                np.testing.assert_array_equal(msg.value.densify()[:4], _SPARSE[:4])
                assert reg.snapshot()["counters"]["comm.frames_rejected"] == 1
                pairs[2][2].close()
                token, msg, dead = await asyncio.wait_for(mux.__anext__(), 10)
                assert (token, msg, dead) == (2, None, pairs[2][1])
                assert mux.tokens() == (0, 1)
        finally:
            mux.close()
            for server, rx, tx in pairs:
                tx.close()
                rx.close()
                server.close()
                await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 60))


# --------------------------------------------------------------------- #
# The tree codec                                                        #
# --------------------------------------------------------------------- #
def _reversed_dicts(tree):
    """The same tree with every mapping's keys inserted in reverse
    order (insertion order is not the ravel's order)."""
    if isinstance(tree, dict):
        return {k: _reversed_dicts(tree[k]) for k in reversed(list(tree))}
    return tree


def _converted_trees():
    """One agent's WRN-10-1 parameters through ``convert.torch_to_flax``:
    the reference's tree (numpy, one leaf bfloat16 through ml_dtypes) and
    the port's (torch tensors with the same bits, keys inserted in
    reverse)."""
    model = WideResNet(10, 1, n_agents=1, device="cpu", seed=0)
    flat = {name: p[0].detach().numpy() for name, p in model.stacked_parameters().items()}
    ref = convert.torch_to_flax(flat)
    bf16_path = ("Dense_0", "kernel")
    ref[bf16_path[0]][bf16_path[1]] = ref[bf16_path[0]][bf16_path[1]].astype(ml_dtypes.bfloat16)

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        if node.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(node.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(node))

    return ref, _reversed_dicts(to_torch(ref))


def test_tree_to_flat_equals_the_reference_bit_for_bit():
    ref_tree, port_tree = _converted_trees()
    r_flat, r_spec = r_pytree.tree_to_flat(ref_tree)
    p_flat, p_spec = p_pytree.tree_to_flat(port_tree)
    assert p_flat.dtype == np.float32
    assert p_flat.tobytes() == np.asarray(r_flat).tobytes()
    assert p_spec.dtype_buckets() == r_spec.dtype_buckets()
    assert [name for name, _ in p_spec.dtype_buckets()] == ["bfloat16", "float32"]
    assert p_spec.shapes == r_spec.shapes and p_spec.total == r_spec.total
    # Back on the CPU: every leaf in its shape and dtype, bit for bit.
    back = p_pytree.flat_to_tree(p_flat, p_spec, device="cpu")
    ref_back = r_pytree.flat_to_tree(r_flat, r_spec)

    def check(a, b, r):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                check(a[k], b[k], r[k])
            return
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
        raw = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        assert raw.numpy().tobytes() == np.asarray(r).tobytes()

    check(back, port_tree, ref_back)
    # The port's buckets drive a fused frame equal to the reference's.
    q = np.where(np.random.default_rng(0).random(p_flat.size) < 0.1, p_flat, 0).astype(np.float32)
    assert (p_tc.encode_fused_sparse(q, p_spec.dtype_buckets())
            == r_tc.encode_fused_sparse(q, r_spec.dtype_buckets()))


def test_tree_codec_rejects_what_it_cannot_carry():
    with pytest.raises(TypeError, match="non-float"):
        p_pytree.tree_to_flat({"step": torch.zeros(3, dtype=torch.int32)})
    flat, spec = p_pytree.tree_to_flat({"b": [torch.ones(2), (torch.zeros(1),)], "a": torch.ones(3)})
    np.testing.assert_array_equal(flat, [1, 1, 1, 1, 1, 0])
    back = p_pytree.flat_to_tree(flat, spec, device="cpu")
    assert isinstance(back["b"], list) and isinstance(back["b"][1], tuple)
    with pytest.raises(ValueError, match="spec expects"):
        p_pytree.flat_to_tree(flat[:-1], spec, device="cpu")
    empty, espec = p_pytree.tree_to_flat({})
    assert empty.size == 0 and espec.dtype_buckets() == ()


# --------------------------------------------------------------------- #
# top-k selection, the sparse codec, the package surface                #
# --------------------------------------------------------------------- #
def test_top_k_sparse_and_compressor_equal_the_reference():
    rng = np.random.default_rng(1)
    v = rng.normal(size=10_000).astype(np.float32)
    w = np.zeros(64, np.float32)
    w[[3, 9]] = [5.0, -4.0]
    w[[30, 10, 50]] = [2.0, -2.0, 2.0]   # a 3-way tie at the boundary, 2 slots
    nan = v.copy()
    nan[[17, 4000]] = np.nan
    for vec, k in ((v, 100), (w, 4), (nan, 50), (v, 0), (w, 1000)):
        pi, pv = p_tc.top_k_sparse(vec, k)
        ri, rv = r_tc.top_k_sparse(vec, k)
        assert pi.dtype == np.uint32
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(p_tc.top_k_sparse(w, 4)[0], [3, 9, 10, 30])
    assert {17, 4000} <= set(p_tc.top_k_sparse(nan, 50)[0].tolist())
    for frac in (0.25, 0.01, 1.0):
        for vec in (np.arange(8, dtype=np.float32) - 4.0, v.reshape(100, 100)):
            np.testing.assert_array_equal(p_comm.top_k_compressor(frac)(vec),
                                          r_top_k_compressor(frac)(vec))
    with pytest.raises(ValueError, match="fraction"):
        p_comm.top_k_compressor(0.0)


def test_sparse_codec_rejects_corrupt_and_hostile_frames_as_the_reference():
    good = p_tc.encode_sparse(np.eye(4, dtype=np.float32))
    bad = bytearray(good)
    bad[16:20] = (10 ** 6).to_bytes(4, "little")
    cases = [p_tc.encode_tensor(np.zeros(3, np.float32)), good[: len(good) // 2], bytes(bad),
             struct.pack("<BBBB2I", 0xFF, 0, 2, 0, 1 << 31, 2) + struct.pack("<I", 0) + b"\0" * 4,
             b"\xff\x00\x02\x00" + b"\x01\x00\x00\x00"]
    for frame in cases:
        with pytest.raises(ValueError) as port:
            p_tc.decode_sparse(frame)
        with pytest.raises(ValueError) as ref:
            r_tc.decode_sparse(frame)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="truncated"):
        p_tc.decode_tensor(p_tc.encode_tensor(np.ones(10, np.float32))[:-5])
    with pytest.raises(ValueError, match="mutually exclusive"):
        p_tc.encode_tensor(np.ones(3, np.float32), bf16_wire=True, int8_wire=True)


def test_comm_package_names_and_the_unported_runtime():
    from distributed_learning_tpu import comm as r_comm

    ported = set(r_comm._LAZY) - set(p_comm._UNPORTED)
    assert set(p_comm._LAZY) == ported
    assert set(p_comm.__all__) == ported | {"top_k_compressor"}
    for name in ported:
        assert getattr(p_comm, name) is not None
    assert p_comm.encode_tensor is p_tc.encode_tensor
    for name in ("ConsensusAgent", "ConsensusMaster", "AsyncGossipRunner", "FaultPlan"):
        with pytest.raises(AttributeError, match='ROADMAP.md queue 1, "comm/ runtime"'):
            getattr(p_comm, name)
    with pytest.raises(AttributeError, match="no attribute"):
        p_comm.no_such_name
