"""Multi-process communication backend: the wire layer (port of
``distributed_learning_tpu/comm/``).

Typed binary messages (``protocol``), crc32-checked framing over asyncio
TCP streams (``framing``), an async select over many streams
(``multiplexer``), the tensor codec with the port's native engine
(``tensor_codec``, ``native/``) and the tree <-> wire vector adapter for
torch tensors (``pytree_codec``).  Frames are the JAX package's, byte for
byte, so a port agent and a JAX agent speak one wire.

The runtime on top of it (``ConsensusAgent``, ``ConsensusMaster``,
``AsyncGossipRunner``, the fault harness) is not ported yet: those names
raise an ``AttributeError`` that names its ROADMAP.md item.
"""

import importlib

# PEP 562 lazy re-exports: the JAX package's table, limited to the names
# ported; a submodule loads at the first access of one of its names.
_LAZY = {
    "FramedStream": ("framing", "FramedStream"),
    "FrameError": ("framing", "FrameError"),
    "open_framed_connection": ("framing", "open_framed_connection"),
    "StreamMultiplexer": ("multiplexer", "StreamMultiplexer"),
    "decode_fused_sparse": ("tensor_codec", "decode_fused_sparse"),
    "decode_sparse": ("tensor_codec", "decode_sparse"),
    "decode_tensor": ("tensor_codec", "decode_tensor"),
    "encode_fused_sparse": ("tensor_codec", "encode_fused_sparse"),
    "encode_sparse": ("tensor_codec", "encode_sparse"),
    "encode_tensor": ("tensor_codec", "encode_tensor"),
    "top_k_sparse": ("tensor_codec", "top_k_sparse"),
}

# The JAX package's runtime names, not ported yet.
_UNPORTED = (
    "AgentStatus", "ConsensusAgent", "RoundAbortedError", "ShutdownError",
    "AsyncGossipRunner", "AsyncRoundStats", "QUARANTINE_PAYLOAD_KIND",
    "FaultPlan", "FaultyStream", "inject_neighbor_faults", "lying_fields_mutator",
    "poison_value_mutator", "ConsensusMaster",
)


def __getattr__(name):
    if name in _UNPORTED:
        raise AttributeError(
            f"{name} is part of the comm runtime, not ported yet: ROADMAP.md "
            'queue 1, "comm/ runtime"'
        )
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
