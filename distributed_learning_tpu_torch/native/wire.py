"""ctypes wrapper for the native wire engine (``wire.cpp``); port of
``distributed_learning_tpu/native/wire.py``.

The frame FORMAT is owned by :mod:`distributed_learning_tpu_torch.comm.tensor_codec`
— its pure-Python implementation stays the byte-for-byte authoritative
oracle and the ``DLT_NO_NATIVE=1`` fallback.  This module only makes the
native whole-frame paths callable:

* :func:`encode_fused` / :func:`decode_fused` — fused sparse frames in
  one native call each (u32 gather/scatter fused with the bf16/int8 wire
  conversion, slicing-by-8 crc32 over the assembled frame);
* :func:`encode_dense` / :func:`decode_dense` — dense tensor frames for
  the f32-sourced wire modes.

Status discipline: corrupt frames surface as
:class:`~distributed_learning_tpu_torch.comm.tensor_codec.CodecError` (raised
by the caller from :data:`ERR_*`), and :data:`ERR_UNSUPPORTED` means "a
valid frame this engine does not speak — decode it with the Python
oracle instead" (never an error to the peer).

Availability is decided per call: ``available()`` is False whenever the
library cannot build/load *or* ``DLT_NO_NATIVE=1`` is set in the
environment at call time, so tests (and operators) can force the
fallback without restarting the process.  The library is built into the
package's ``_build/`` directory (see :mod:`distributed_learning_tpu_torch.native`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from distributed_learning_tpu_torch.native import _HERE, disabled, load

__all__ = [
    "available",
    "encode_fused",
    "decode_fused",
    "decode_apply",
    "validate_fused",
    "encode_dense",
    "decode_dense",
    "crc32",
    "MODE_F32",
    "MODE_BF16",
    "MODE_I8",
    "ERR_UNSUPPORTED",
    "ERR_NONFINITE",
]

_SRC = os.path.join(_HERE, "wire.cpp")

#: Per-bucket / dense wire modes (wire.cpp kMode*).
MODE_F32, MODE_BF16, MODE_I8 = 0, 1, 2

#: Status codes (wire.cpp kErr*).
ERR_TRUNC = -1
ERR_MAGIC = -2
ERR_VERSION = -3
ERR_CRC = -4
ERR_BOUNDS = -5
ERR_RANGE = -6
ERR_TOTAL = -7
ERR_UNSUPPORTED = -8
ERR_NONFINITE = -9
ERR_INTERNAL = -10

#: Corrupt-frame statuses -> the message the caller raises (parity with
#: the Python oracle's wording so tests can match either path).
CORRUPT_MESSAGES = {
    ERR_TRUNC: "fused sparse frame truncated",
    ERR_MAGIC: "not a fused sparse frame",
    ERR_VERSION: "unsupported fused sparse frame version",
    ERR_CRC: "fused sparse frame checksum mismatch",
    ERR_BOUNDS: "fused sparse frame section out of bounds",
    ERR_RANGE: "fused sparse index out of range",
    ERR_TOTAL: "fused sparse frame total mismatch",
    ERR_INTERNAL: "native wire engine internal error",
}


def _configure(lib: ctypes.CDLL) -> None:
    u64p = ctypes.c_void_p
    lib.dlt_wire_crc32.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
    ]
    lib.dlt_wire_crc32.restype = ctypes.c_uint32
    lib.dlt_wire_fused_size.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u64p, u64p, u64p,
        ctypes.c_void_p, ctypes.c_uint32, u64p, ctypes.c_void_p,
    ]
    lib.dlt_wire_fused_size.restype = ctypes.c_longlong
    lib.dlt_wire_fused_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u64p, u64p, u64p,
        ctypes.c_void_p, ctypes.c_uint32, u64p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.dlt_wire_fused_encode.restype = ctypes.c_longlong
    lib.dlt_wire_fused_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.dlt_wire_fused_decode.restype = ctypes.c_longlong
    lib.dlt_wire_fused_apply.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_float,
    ]
    lib.dlt_wire_fused_apply.restype = ctypes.c_longlong
    lib.dlt_wire_fused_validate.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.dlt_wire_fused_validate.restype = ctypes.c_longlong
    lib.dlt_wire_dense_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.dlt_wire_dense_encode.restype = ctypes.c_longlong
    lib.dlt_wire_dense_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.dlt_wire_dense_decode.restype = ctypes.c_longlong


def _load() -> Optional[ctypes.CDLL]:
    return load(_SRC, _configure)


def available() -> bool:
    """True iff the native engine is loadable AND not disabled by
    ``DLT_NO_NATIVE=1`` right now (checked per call, not cached, so the
    fallback can be forced mid-process)."""
    return not disabled() and _load() is not None


def crc32(data: bytes, seed: int = 0) -> int:
    """Slicing-by-8 crc32 (zlib-compatible); requires :func:`available`."""
    lib = _load()
    return int(lib.dlt_wire_crc32(data, len(data), ctypes.c_uint32(seed)))


def _span_arrays(
    buckets: Sequence[Tuple[int, Sequence[Tuple[int, int]]]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(span_off, span_size, bucket_ptr, modes) CSR arrays for the C ABI.

    ``buckets`` is ``((mode, ((off, size), ...)), ...)`` — dtype names
    already resolved to wire modes by the caller.
    """
    modes = np.asarray([m for m, _ in buckets], dtype=np.uint8)
    ptr = np.zeros(len(buckets) + 1, dtype=np.uint64)
    offs, sizes = [], []
    for b, (_mode, spans) in enumerate(buckets):
        for off, size in spans:
            offs.append(off)
            sizes.append(size)
        ptr[b + 1] = len(offs)
    span_off = np.asarray(offs, dtype=np.uint64)
    span_size = np.asarray(sizes, dtype=np.uint64)
    return span_off, span_size, ptr, modes


def encode_fused(
    flat: np.ndarray,
    buckets: Sequence[Tuple[int, Sequence[Tuple[int, int]]]],
) -> Optional[bytes]:
    """Encode one fused sparse frame from the f32 ravel in two native
    passes (measure, then gather+convert+crc into an exact-size buffer).

    Returns the frame bytes, ``None`` when the engine is unavailable, or
    raises ``ValueError`` for the int8-over-nonfinite-values contract
    (the caller re-raises as its own error type).
    """
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, dtype=np.float32)
    span_off, span_size, ptr, modes = _span_arrays(buckets)
    ks = np.zeros(len(buckets), dtype=np.uint64)
    maxabs = np.zeros(len(buckets), dtype=np.float32)
    size = int(lib.dlt_wire_fused_size(
        flat.ctypes.data, ctypes.c_uint64(flat.size),
        span_off.ctypes.data, span_size.ctypes.data, ptr.ctypes.data,
        modes.ctypes.data, ctypes.c_uint32(len(buckets)),
        ks.ctypes.data, maxabs.ctypes.data,
    ))
    if size == ERR_NONFINITE:
        raise ValueError(
            "int8 wire requires finite values; refusing to quantize a "
            "poisoned tensor"
        )
    if size < 0:  # pragma: no cover - defensive
        raise ValueError(CORRUPT_MESSAGES.get(size, f"wire status {size}"))
    out = np.empty(size, dtype=np.uint8)
    n = int(lib.dlt_wire_fused_encode(
        flat.ctypes.data, ctypes.c_uint64(flat.size),
        span_off.ctypes.data, span_size.ctypes.data, ptr.ctypes.data,
        modes.ctypes.data, ctypes.c_uint32(len(buckets)),
        ks.ctypes.data, maxabs.ctypes.data,
        out.ctypes.data, ctypes.c_uint64(size),
    ))
    if n != size:  # pragma: no cover - defensive
        raise ValueError(CORRUPT_MESSAGES[ERR_INTERNAL])
    return out.tobytes()


def decode_fused(buf: bytes, out: np.ndarray) -> int:
    """Decode one fused sparse frame into the caller's f32 ravel.

    The ravel's prior contents are ignored — the native side zero-fills
    it between validation and scatter, so reused (dirty) scratch
    buffers are safe.  Returns 0 on success or :data:`ERR_UNSUPPORTED`
    (caller falls back to the Python oracle); corrupt frames return
    their negative status (caller raises ``CodecError`` with
    :data:`CORRUPT_MESSAGES`).  The native side verifies the crc and
    bounds-checks every section header BEFORE the first write.
    """
    lib = _load()
    assert lib is not None, "decode_fused requires available()"
    return int(lib.dlt_wire_fused_decode(
        buf, ctypes.c_uint64(len(buf)),
        out.ctypes.data, ctypes.c_uint64(out.size),
    ))


def decode_apply(buf: bytes, target: np.ndarray, scale: float = 1.0) -> int:
    """Scatter-ADD one fused sparse frame into a live f32 ravel
    (``target[idx] += scale * vals``), no dense intermediate.

    Same status discipline and validate-before-first-write guarantee as
    :func:`decode_fused`; untouched positions of ``target`` keep their
    exact bytes.  For the duplicate-free frames the encoder produces,
    the result is ulp-identical to decode-then-``target += scale *
    dense``.
    """
    lib = _load()
    assert lib is not None, "decode_apply requires available()"
    return int(lib.dlt_wire_fused_apply(
        buf, ctypes.c_uint64(len(buf)),
        target.ctypes.data, ctypes.c_uint64(target.size),
        ctypes.c_float(scale),
    ))


def validate_fused(buf: bytes, total: int) -> int:
    """Run the full decode-side validation walk (crc + section geometry
    + dtype support + index range) with no output buffer — the
    lazy-payload path's unpack-time corruption check.  Same status
    discipline as :func:`decode_fused`."""
    lib = _load()
    assert lib is not None, "validate_fused requires available()"
    return int(lib.dlt_wire_fused_validate(
        buf, ctypes.c_uint64(len(buf)), ctypes.c_uint64(total),
    ))


def encode_dense(x: np.ndarray, mode: int) -> Optional[bytes]:
    """Whole-frame dense encode of a C-contiguous f32 array under a wire
    mode; ``None`` when unavailable, ``ValueError`` on int8-nonfinite."""
    lib = _load()
    if lib is None:
        return None
    dims = np.asarray(x.shape, dtype=np.uint32)
    hdr = 4 + 4 * x.ndim
    payload = {MODE_F32: 4 * x.size, MODE_BF16: 2 * x.size,
               MODE_I8: 4 + x.size}[mode]
    out = np.empty(hdr + payload, dtype=np.uint8)
    n = int(lib.dlt_wire_dense_encode(
        x.ctypes.data, ctypes.c_uint64(x.size),
        dims.ctypes.data, ctypes.c_uint32(x.ndim), ctypes.c_uint32(mode),
        out.ctypes.data, ctypes.c_uint64(out.size),
    ))
    if n == ERR_NONFINITE:
        raise ValueError(
            "int8 wire requires finite values; refusing to quantize a "
            "poisoned tensor"
        )
    if n != out.size:  # pragma: no cover - defensive
        raise ValueError(CORRUPT_MESSAGES[ERR_INTERNAL])
    return out.tobytes()


def decode_dense(buf: bytes, out: np.ndarray) -> int:
    """Whole-frame dense decode into the caller's f32 buffer (sized from
    the pre-parsed header).  0, ERR_UNSUPPORTED, or a corrupt status."""
    lib = _load()
    assert lib is not None, "decode_dense requires available()"
    return int(lib.dlt_wire_dense_decode(
        buf, ctypes.c_uint64(len(buf)),
        out.ctypes.data, ctypes.c_uint64(out.size),
    ))
