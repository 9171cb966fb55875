"""Multi-process communication backend (port of
``distributed_learning_tpu/comm/``).

The wire layer: typed binary messages (``protocol``), crc32-checked
framing over asyncio TCP streams (``framing``), an async select over many
streams (``multiplexer``), the tensor codec with the port's native engine
(``tensor_codec``, ``native/``) and the tree <-> wire vector adapter for
torch tensors (``pytree_codec``).  Frames are the JAX package's, byte for
byte, so a port agent and a JAX agent speak one wire.

The runtime on top of it: ``ConsensusMaster`` (topology, weights, round
gating, elastic membership, quarantine), ``ConsensusAgent`` (lock-step
gossip, CHOCO over the wire, master rounds), ``AsyncGossipRunner``
(staleness-bounded async rounds and async CHOCO) and the fault harness
(``FaultPlan``, ``FaultyStream``, ``inject_neighbor_faults``).  Their
values are torch tensors on the caller's device; the host arithmetic is
the reference's.
"""

import importlib

# PEP 562 lazy re-exports (the JAX package's table): a submodule loads at
# the first access of one of its names.
_LAZY = {
    "AgentStatus": ("agent", "AgentStatus"),
    "ConsensusAgent": ("agent", "ConsensusAgent"),
    "RoundAbortedError": ("agent", "RoundAbortedError"),
    "ShutdownError": ("agent", "ShutdownError"),
    "AsyncGossipRunner": ("async_runtime", "AsyncGossipRunner"),
    "AsyncRoundStats": ("async_runtime", "AsyncRoundStats"),
    "QUARANTINE_PAYLOAD_KIND": ("async_runtime", "QUARANTINE_PAYLOAD_KIND"),
    "FaultPlan": ("faults", "FaultPlan"),
    "FaultyStream": ("faults", "FaultyStream"),
    "inject_neighbor_faults": ("faults", "inject_neighbor_faults"),
    "lying_fields_mutator": ("faults", "lying_fields_mutator"),
    "poison_value_mutator": ("faults", "poison_value_mutator"),
    "FramedStream": ("framing", "FramedStream"),
    "FrameError": ("framing", "FrameError"),
    "open_framed_connection": ("framing", "open_framed_connection"),
    "ConsensusMaster": ("master", "ConsensusMaster"),
    "StreamMultiplexer": ("multiplexer", "StreamMultiplexer"),
    "decode_fused_sparse": ("tensor_codec", "decode_fused_sparse"),
    "decode_sparse": ("tensor_codec", "decode_sparse"),
    "decode_tensor": ("tensor_codec", "decode_tensor"),
    "encode_fused_sparse": ("tensor_codec", "encode_fused_sparse"),
    "encode_sparse": ("tensor_codec", "encode_sparse"),
    "encode_tensor": ("tensor_codec", "encode_tensor"),
    "top_k_sparse": ("tensor_codec", "top_k_sparse"),
}


def __getattr__(name):
    try:
        submodule, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    module = importlib.import_module(f"distributed_learning_tpu_torch.comm.{submodule}")
    value = getattr(module, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


def top_k_compressor(fraction: float):
    """Host-side top-k compressor: keeps the ``fraction`` of entries of
    largest magnitude (``tensor_codec.top_k_sparse``: ties to the lowest
    indices, NaN kept) and returns them densified in the input's shape."""
    import numpy as np

    from distributed_learning_tpu_torch.comm.tensor_codec import top_k_sparse

    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")

    def compress(v: "np.ndarray") -> "np.ndarray":
        flat = np.asarray(v, np.float32).ravel()
        k = max(1, int(round(fraction * flat.size)))
        idx, vals = top_k_sparse(flat, k)
        out = np.zeros_like(flat)
        out[idx] = vals
        return out.reshape(np.shape(v))

    return compress


__all__ = sorted(_LAZY) + ["top_k_compressor"]
