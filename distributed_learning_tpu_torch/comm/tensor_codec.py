"""Binary tensor wire format for the TCP comm backend (port of
``distributed_learning_tpu/comm/tensor_codec.py``: the same frames, byte
for byte, from numpy arrays; the port's torch tensors cross this layer
as numpy through :mod:`.pytree_codec`).

Replaces the reference's pickled-numpy payloads
(``utils/consensus_tcp/pickled_socket.py:12,23`` — arbitrary code execution
from any peer, and f64-sized frames) with a fixed, safe layout:

    u8 dtype_code | u8 flags | u8 ndim | u8 reserved |
    u32 dim[ndim] | raw little-endian data

``flags`` bit 0 marks a float32 tensor narrowed to bfloat16 on the wire
(half the bytes; round-to-nearest-even via the native codec) — the TPU
wire format for gossip values.  ``flags`` bit 1 marks symmetric int8
quantization (quarter bytes: one f32 scale = max|x|/127 ahead of the
int8 payload) — the CHOCO-wire option whose quantization error the
error-feedback loop absorbs.  Integrity is checked one level up by the
frame crc32 (``framing.py``); the fused sparse frame additionally
carries its OWN trailing crc32 (see ``encode_fused_sparse``) so its
decoder can reject corruption before the first scatter into the ravel.

Native wire engine: the dense frame path and the fused sparse
frame path route through ``native/wire.cpp`` when it builds — whole
frames encoded/decoded in one call, the u32 gather/scatter fused with
the bf16/int8 conversion, a slicing-by-8 crc over the assembled frame.
THIS module's pure-Python implementation stays the byte-for-byte
authoritative oracle and the ``DLT_NO_NATIVE=1`` fallback; the native
path must produce identical bytes (pinned by ``tests/test_wire.py``).
Every encode/decode records which path served on the ``comm.wire.native``
gauge of the port's obs registry, so run reports say which engine a
measurement ran on.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from distributed_learning_tpu_torch import native
from distributed_learning_tpu_torch.native import wire as native_wire

__all__ = [
    "CodecError",
    "encode_tensor",
    "decode_tensor",
    "encode_sparse",
    "decode_sparse",
    "encode_fused_sparse",
    "decode_fused_sparse",
    "decode_fused_apply",
    "FusedFrame",
    "DenseFrame",
    "SparseFrame",
    "top_k_sparse",
    "FLAG_BF16_COMPRESSED",
    "FLAG_INT8_COMPRESSED",
]


class CodecError(ValueError):
    """Corrupt or protocol-violating tensor frame.

    Subclasses ``ValueError`` so pre-existing callers (and tests) that
    catch the broad class keep working; raised by the wire-engine paths
    for every corruption class — truncation, checksum mismatch, section
    lengths/offsets out of bounds, scatter indices outside the ravel —
    and NEVER accompanied by a partial write (decode validates before it
    scatters, both native and Python)."""

FLAG_BF16_COMPRESSED = 0x01
FLAG_INT8_COMPRESSED = 0x02

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4,
    np.dtype(np.uint16): 5,  # raw bfloat16 bit patterns
    np.dtype(np.bool_): 6,
    np.dtype(np.int8): 7,  # int8-quantized wire payloads
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_MAX_NDIM = 16
# Densification cap for sparse frames: 2^28 f32 elements = 1 GiB, matching
# the largest single gossip tensor the backend is sized for (MAX_FRAME in
# framing.py bounds dense frames the same way).
_MAX_SPARSE_DENSE_ELEMS = 1 << 28


def _wire_engine():
    """The native wire engine module, or None when unavailable or
    disabled (``DLT_NO_NATIVE=1``, honored per call so the fallback can
    be forced without restarting).  Records the serving path on the
    ``comm.wire.native`` gauge — one dict write per FRAME, so run
    reports (and bench records) can say which engine ran."""
    eng = native_wire if native_wire.available() else None
    try:  # lazy: obs is optional at this layer and must not cycle imports
        from distributed_learning_tpu_torch.obs import get_registry

        get_registry().gauge("comm.wire.native", 1.0 if eng else 0.0)
    except Exception:
        pass
    return eng


def encode_tensor(x: np.ndarray, *, bf16_wire: bool = False,
                  int8_wire: bool = False) -> bytes:
    """Serialize an array.

    For f32 payloads ``bf16_wire=True`` halves the bytes (RNE) and
    ``int8_wire=True`` quarters them (symmetric quantization, per-tensor
    f32 scale stored ahead of the int8 data).  Mutually exclusive.
    """
    x = np.asarray(x)
    if bf16_wire and int8_wire:
        raise ValueError("bf16_wire and int8_wire are mutually exclusive")
    if not x.flags["C_CONTIGUOUS"]:
        # (ascontiguousarray unconditionally promotes 0-d arrays to 1-d,
        # so only reorder when actually needed.)
        x = np.ascontiguousarray(x)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported wire dtype {x.dtype}")
    if x.ndim > _MAX_NDIM:
        raise ValueError(f"ndim {x.ndim} exceeds wire limit {_MAX_NDIM}")
    if x.dtype == np.dtype(np.float32):
        # Native whole-frame path: header + converted payload written
        # into one preallocated buffer (wire.cpp), byte-identical to the
        # Python assembly below.
        eng = _wire_engine()
        if eng is not None:
            mode = (
                native_wire.MODE_BF16 if bf16_wire
                else native_wire.MODE_I8 if int8_wire
                else native_wire.MODE_F32
            )
            try:
                frame = eng.encode_dense(x, mode)
            except ValueError as exc:
                raise CodecError(str(exc)) from None
            if frame is not None:
                return frame
    flags = 0
    payload = x
    prefix = b""
    if bf16_wire and x.dtype == np.float32:
        payload = native.f32_to_bf16(x)
        flags |= FLAG_BF16_COMPRESSED
    elif int8_wire and x.dtype == np.float32:
        scale = float(np.max(np.abs(x)) / 127.0) if x.size else 0.0
        if not np.isfinite(scale):
            # A NaN/Inf anywhere poisons max|x| (and would quantize the
            # whole tensor to garbage, platform-dependently).  Loud, not
            # dropped — same stance as top_k_sparse.  CodecError (a
            # ValueError) so both wire-engine paths raise the same class.
            raise CodecError(
                "int8 wire requires finite values (scale came out "
                f"{scale}); refusing to quantize a poisoned tensor"
            )
        payload = native.f32_to_i8(x, scale)
        flags |= FLAG_INT8_COMPRESSED
        prefix = struct.pack("<f", scale)
    header = struct.pack(
        f"<BBBB{x.ndim}I",
        _DTYPE_CODES[np.dtype(payload.dtype)],
        flags,
        x.ndim,
        0,
        *x.shape,
    )
    return header + prefix + payload.tobytes()


def _check_out(out: np.ndarray, count: int) -> None:
    """Validate a caller-supplied scratch ravel for the ``out=`` decode
    contract: C-contiguous writable f32 of exactly ``count`` elements.
    A mismatch is a caller bug (ValueError), never a wire error."""
    if not isinstance(out, np.ndarray):
        raise ValueError("out= must be a numpy ndarray")
    if out.dtype != np.dtype(np.float32):
        raise ValueError(f"out= must be float32, got {out.dtype}")
    if not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]:
        raise ValueError("out= must be C-contiguous and writable")
    if out.size != count:
        raise ValueError(
            f"out= holds {out.size} elements, frame decodes {count}"
        )


def _parse_tensor(buf: bytes):
    """Header parse + full length validation of a dense tensor frame —
    the O(1) half of :func:`decode_tensor`, shared with the lazy
    :class:`DenseFrame` payload.  Returns ``(code, flags, dims, dtype,
    scale, payload_offset, count, data)``."""
    if len(buf) < 4:
        raise ValueError("tensor frame too short")
    code, flags, ndim, _ = struct.unpack_from("<BBBB", buf, 0)
    if code not in _CODE_DTYPES:
        raise ValueError(f"unknown wire dtype code {code}")
    if ndim > _MAX_NDIM:
        raise ValueError(f"ndim {ndim} exceeds wire limit {_MAX_NDIM}")
    dims: Tuple[int, ...] = struct.unpack_from(f"<{ndim}I", buf, 4)
    offset = 4 + 4 * ndim
    dtype = _CODE_DTYPES[code]
    scale = None
    if flags & FLAG_INT8_COMPRESSED:
        if dtype != np.dtype(np.int8):
            raise ValueError("int8 flag on a non-int8 payload")
        (scale,) = struct.unpack_from("<f", buf, offset)
        offset += 4
    count = int(np.prod(dims, dtype=np.int64)) if ndim else 1
    expect = count * dtype.itemsize
    data = buf[offset : offset + expect]
    if len(data) != expect:
        raise ValueError(
            f"tensor frame truncated: want {expect} payload bytes, "
            f"have {len(data)}"
        )
    return code, flags, dims, dtype, scale, offset, count, data


def decode_tensor(buf: bytes, *, out: "np.ndarray" = None) -> np.ndarray:
    """Inverse of :func:`encode_tensor` (bf16 wire data returns as f32).

    ``out=`` (optional) is a reusable f32 scratch ravel of exactly the
    frame's element count: the decode writes into it (every element —
    prior contents never leak) and returns it reshaped, skipping the
    per-frame allocation.  Bytes are identical to the allocating path.
    """
    code, flags, dims, dtype, scale, offset, count, data = \
        _parse_tensor(buf)
    if out is not None:
        _check_out(out, count)
    if (
        flags & (FLAG_BF16_COMPRESSED | FLAG_INT8_COMPRESSED)
        and len(buf) == offset + len(data)
        and code in (5, 7)
    ):
        # Native whole-frame decode for the converting layouts (bf16 and
        # int8 payloads): parse + convert in one call.  Raw frames keep
        # the zero-copy numpy view below; a buffer with trailing slack
        # (tolerated here) also stays on the Python path.
        eng = _wire_engine()
        if eng is not None:
            target = out.reshape(dims) if out is not None \
                else np.empty(dims, np.float32)
            if eng.decode_dense(buf, target) == 0:
                return target
    x = np.frombuffer(data, dtype=dtype).reshape(dims)
    if flags & FLAG_BF16_COMPRESSED:
        # The converters ravel: reshape back so the 0-d/N-d frame shape
        # survives the fallback path exactly as it does in-engine.
        x = native.bf16_to_f32(x).reshape(dims)
    elif flags & FLAG_INT8_COMPRESSED:
        x = native.i8_to_f32(x, scale).reshape(dims)
    if out is not None:
        ret = out.reshape(dims)
        np.copyto(ret, x, casting="unsafe")
        return ret
    return x


# --------------------------------------------------------------------- #
# Sparse wire format (compressed-gossip corrections)                    #
# --------------------------------------------------------------------- #
def encode_sparse(x: np.ndarray, *, bf16_wire: bool = False,
                  int8_wire: bool = False) -> bytes:
    """Serialize only the non-zero entries of a (dense) array.

    The wire for CHOCO-style corrections
    (:mod:`distributed_learning_tpu_torch.parallel.compression`): a top-k
    compressed correction is dense in memory but k-sparse in content, so
    the payload is ``shape | u32 indices[k] | values[k]`` — ``O(k)`` bytes
    instead of ``O(d)``.  Values ride :func:`encode_tensor` (so
    ``bf16_wire`` composes), indices are flat positions into the C-order
    ravel.  Per entry the sparse wire costs 4 (index) + 2 (bf16 value)
    bytes vs 2 dense, so it wins below ~1/3 density (f32: 8 vs 4, below
    ~1/2; int8: 5 vs 1, below ~1/5) — at CHOCO's typical 1-10% top-k
    fractions a 3-33x (bf16) / 5-50x (f32) byte reduction; measured 6.6x
    at 5% top-k, bf16.  ``int8_wire`` quantizes the value payload
    (scale from the non-zero values only, so sparsity does not waste
    quantization range).
    """
    x = np.asarray(x)
    flat = x.ravel()  # C-order view (copy when non-contiguous)
    if flat.size > _MAX_SPARSE_DENSE_ELEMS:
        # Mirror decode_sparse's densification cap: failing here is a clear
        # local error instead of an opaque decode failure on every peer.
        raise ValueError(
            f"sparse wire limited to {_MAX_SPARSE_DENSE_ELEMS} dense "
            f"elements, got {flat.size}"
        )
    if x.ndim > _MAX_NDIM:
        # Same clear-local-error policy: decode_sparse rejects ndim >
        # _MAX_NDIM, so encoding it would fail on every peer instead.
        raise ValueError(f"ndim {x.ndim} exceeds wire limit {_MAX_NDIM}")
    idx = np.flatnonzero(flat).astype(np.uint32)
    vals = flat[idx]
    header = struct.pack(f"<BBBB{x.ndim}I", 0xFF, 0, x.ndim, 0, *x.shape)
    return (
        header
        + struct.pack("<I", idx.size)
        + idx.tobytes()
        + encode_tensor(vals, bf16_wire=bf16_wire, int8_wire=int8_wire)
    )


def _parse_sparse(buf: bytes):
    """The O(k) half of :func:`decode_sparse`: full validation + value
    decode, NO densification.  Returns ``(dims, count, idx, vals)``."""
    if len(buf) < 4:
        raise ValueError("sparse frame too short")
    magic, _flags, ndim, _ = struct.unpack_from("<BBBB", buf, 0)
    if magic != 0xFF:
        raise ValueError(f"not a sparse tensor frame (magic {magic:#x})")
    if ndim > _MAX_NDIM:
        raise ValueError(f"ndim {ndim} exceeds wire limit {_MAX_NDIM}")
    if len(buf) < 4 + 4 * ndim + 4:
        raise ValueError("sparse frame truncated in header")
    dims: Tuple[int, ...] = struct.unpack_from(f"<{ndim}I", buf, 4)
    offset = 4 + 4 * ndim
    (k,) = struct.unpack_from("<I", buf, offset)
    offset += 4
    count = int(np.prod(dims, dtype=np.int64)) if ndim else 1
    if count > _MAX_SPARSE_DENSE_ELEMS:
        # The dense target is allocated from the (untrusted) shape header
        # alone — unlike dense frames, the payload length scales with k,
        # not count, so a tiny frame could otherwise demand an unbounded
        # allocation.
        raise ValueError(
            f"sparse frame densifies to {count} elements "
            f"(limit {_MAX_SPARSE_DENSE_ELEMS})"
        )
    if k > count:
        raise ValueError(f"sparse frame claims {k} entries in {count} slots")
    idx_bytes = buf[offset : offset + 4 * k]
    if len(idx_bytes) != 4 * k:
        raise ValueError("sparse frame truncated in indices")
    idx = np.frombuffer(idx_bytes, dtype=np.uint32)
    offset += 4 * k
    if k and int(idx.max()) >= count:
        raise ValueError("sparse index out of range")
    vals = decode_tensor(buf[offset:])
    if vals.shape != (k,):
        raise ValueError(f"sparse frame value count {vals.shape} != {k}")
    return dims, count, idx, vals


def decode_sparse(buf: bytes, *, out: "np.ndarray" = None) -> np.ndarray:
    """Inverse of :func:`encode_sparse`; returns the densified array.

    ``out=`` (optional) is a reusable f32 scratch ravel of the frame's
    dense element count: the decode zero-fills it, scatters into it,
    and returns it reshaped — prior (dirty) contents never leak.  The
    result dtype is then f32 regardless of the value section's dtype
    (the scatter casts on assignment, same values as the allocating
    path for the f32-sourced wire modes)."""
    dims, count, idx, vals = _parse_sparse(buf)
    if out is not None:
        _check_out(out, count)
        out.fill(0.0)
        out[idx] = vals
        return out.reshape(dims)
    dense = np.zeros(count, dtype=vals.dtype)
    dense[idx] = vals
    return dense.reshape(dims)


# --------------------------------------------------------------------- #
# Fused sparse wire format (one frame per gossip round)                 #
# --------------------------------------------------------------------- #
_FUSED_MAGIC = 0xFE
#: Fused frame version.  v1 added the version byte itself and
#: the trailing frame crc32, so the decoder — whose scatter writes into a
#: freshly allocated ravel — rejects corruption before touching it.
_FUSED_VERSION = 1
#: bf16-precision storage dtypes: their value sections always narrow to
#: bf16 on the wire (that IS their information content).
_BF16_ORIGIN = ("bfloat16", "float16")


def _bucket_modes(buckets, bf16_wire: bool, int8_wire: bool):
    """Per-bucket wire mode (native_wire.MODE_*): bf16-origin buckets
    always ride bf16 values, f32 buckets honor ``bf16_wire``, and
    ``int8_wire`` quantizes every section."""
    modes = []
    for name, _spans in buckets:
        if int8_wire:
            modes.append(native_wire.MODE_I8)
        elif bf16_wire or name in _BF16_ORIGIN:
            modes.append(native_wire.MODE_BF16)
        else:
            modes.append(native_wire.MODE_F32)
    return tuple(modes)


def encode_fused_sparse(
    x: np.ndarray,
    buckets,
    *,
    bf16_wire: bool = False,
    int8_wire: bool = False,
) -> bytes:
    """Serialize a k-sparse wire vector as ONE frame with one
    ``indices|values`` payload per dtype bucket.

    ``x`` is the dense flat f32 wire vector of a whole model
    (``pytree_codec.tree_to_flat``); ``buckets`` is
    ``TreeSpec.dtype_buckets()`` — leaf spans grouped by ORIGINAL
    storage dtype.  Where per-leaf gossip ships one sparse frame per
    leaf (leaf_count x framing/CRC/headers per neighbor per round), this
    format collapses a round's whole correction to one frame: indices
    are u32 flat positions into the TreeSpec ravel, and each bucket's
    value section is encoded at that bucket's precision — bf16-origin
    leaves ride bf16 values regardless of ``bf16_wire``, f32 buckets
    honor ``bf16_wire``; ``int8_wire`` quantizes every section (the
    CHOCO error-feedback loop absorbs the noise).

    Layout (v1)::

        u8 0xFE | u8 version=1 | u8 nbuckets | u8 0 | u32 total_dim |
        per bucket: u32 k | u32 idx[k] | u32 vlen | encode_tensor(vals) |
        u32 crc32(all preceding bytes)

    The trailing crc is the frame's own integrity check (on top of the
    transport-level one in ``framing.py``): the decoder verifies it — and
    bounds-checks every section header — BEFORE the first scatter into
    the ravel, so corruption raises :class:`CodecError` and never writes.

    When the native wire engine is up, the whole frame is assembled by
    ONE call into ``wire.cpp`` (gather + conversion + crc fused, two
    linear passes over the ravel); the Python loop below is the
    byte-for-byte oracle and the ``DLT_NO_NATIVE=1`` fallback.
    """
    if bf16_wire and int8_wire:
        raise ValueError("bf16_wire and int8_wire are mutually exclusive")
    flat = np.ascontiguousarray(x, dtype=np.float32).ravel()
    if flat.size > _MAX_SPARSE_DENSE_ELEMS:
        raise ValueError(
            f"sparse wire limited to {_MAX_SPARSE_DENSE_ELEMS} dense "
            f"elements, got {flat.size}"
        )
    buckets = tuple(buckets)
    if len(buckets) > 0xFF:
        raise ValueError(f"{len(buckets)} dtype buckets exceed wire limit 255")
    covered = 0
    for _name, spans in buckets:
        for off, size in spans:
            if off < 0 or size < 0 or off + size > flat.size:
                raise ValueError(
                    f"bucket span ({off}, {size}) outside the wire vector "
                    f"of {flat.size} elements"
                )
            covered += size
    if covered != flat.size:
        raise ValueError(
            f"bucket spans cover {covered} of {flat.size} wire elements — "
            "buckets must tile the TreeSpec ravel exactly"
        )
    modes = _bucket_modes(buckets, bf16_wire, int8_wire)
    eng = _wire_engine()
    if eng is not None:
        try:
            frame = eng.encode_fused(
                flat,
                tuple(
                    (mode, spans)
                    for mode, (_name, spans) in zip(modes, buckets)
                ),
            )
        except ValueError as exc:
            raise CodecError(str(exc)) from None
        if frame is not None:
            return frame
    return _encode_fused_sparse_py(flat, buckets, modes)


def _encode_fused_sparse_py(flat: np.ndarray, buckets, modes) -> bytes:
    """The authoritative Python assembly of a fused sparse frame (inputs
    pre-validated by :func:`encode_fused_sparse`)."""
    out = [
        struct.pack(
            "<BBBBI", _FUSED_MAGIC, _FUSED_VERSION, len(buckets), 0,
            flat.size,
        )
    ]
    for (_name, spans), mode in zip(buckets, modes):
        pos = np.concatenate(
            [np.arange(off, off + size, dtype=np.uint32)
             for off, size in spans]
        ) if spans else np.empty(0, np.uint32)
        sub = flat[pos]
        nz = np.flatnonzero(sub)
        idx = pos[nz]
        vals = encode_tensor(
            sub[nz],
            bf16_wire=mode == native_wire.MODE_BF16,
            int8_wire=mode == native_wire.MODE_I8,
        )
        out.append(struct.pack("<I", idx.size))
        out.append(idx.tobytes())
        out.append(struct.pack("<I", len(vals)))
        out.append(vals)
    body = b"".join(out)
    return body + struct.pack("<I", native.crc32(body))


def _parse_fused_header(buf: bytes) -> Tuple[int, int]:
    """Shared header prelude of the fused read paths: returns
    ``(nbuckets, total)`` or raises :class:`CodecError`."""
    if len(buf) < 12:
        raise CodecError("fused sparse frame too short")
    magic, version, nbuckets, _r, total = struct.unpack_from(
        "<BBBBI", buf, 0
    )
    if magic != _FUSED_MAGIC:
        raise CodecError(f"not a fused sparse frame (magic {magic:#x})")
    if total > _MAX_SPARSE_DENSE_ELEMS:
        raise CodecError(
            f"fused sparse frame densifies to {total} elements "
            f"(limit {_MAX_SPARSE_DENSE_ELEMS})"
        )
    if version != _FUSED_VERSION:
        raise CodecError(
            f"unsupported fused sparse frame version {version}"
        )
    return nbuckets, total


def decode_fused_sparse(buf: bytes, *, out: "np.ndarray" = None) -> np.ndarray:
    """Inverse of :func:`encode_fused_sparse`; returns the densified flat
    f32 wire vector (the receiver rebuilds the pytree via its own
    ``TreeSpec`` — the deployment invariant: same model, same spec).

    ``out=`` (optional) is a reusable f32 scratch ravel of ``total``
    elements (the zero-copy receive path): the decode zero-fills it
    between validation and scatter, so dirty scratch never leaks into
    untouched positions, and returns it instead of allocating.

    Corruption discipline (native and Python paths alike): the frame crc
    is verified and every section header bounds-checked BEFORE the first
    scatter write into a freshly-allocated ravel; violations raise
    :class:`CodecError`.  With ``out=``, a frame the ORACLE path rejects
    mid-walk may leave earlier buckets' writes in the scratch — the
    scratch contract is that a failed decode leaves ``out`` unspecified
    (the caller drops the frame and the next decode zero-fills)."""
    nbuckets, total = _parse_fused_header(buf)
    if out is not None:
        _check_out(out, total)
    eng = _wire_engine()
    if eng is not None:
        # The native decode zero-fills the ravel itself (between its
        # validation walk and the scatter), so np.empty — not np.zeros —
        # is correct here: the O(total) clear happens once, page-fault
        # batched, inside the engine.
        target = out if out is not None else np.empty(total, np.float32)
        status = eng.decode_fused(buf, target)
        if status == 0:
            return target
        if status != native_wire.ERR_UNSUPPORTED:
            raise CodecError(
                native_wire.CORRUPT_MESSAGES.get(
                    status, f"wire status {status}"
                )
            )
        # A valid frame with a value dtype the native engine does not
        # speak: the Python oracle below decodes it.
    return _decode_fused_sparse_py(buf, nbuckets, total, out=out)


def _iter_fused_sections(buf: bytes, nbuckets: int, total: int):
    """Walk a fused frame's sections with full validation (crc checked
    FIRST, then per-section bounds/range/shape), yielding
    ``(idx: uint32[k], vals: ndarray[k])`` per bucket — the shared core
    of the Python decode/apply/validate paths."""
    body_end = len(buf) - 4
    (crc,) = struct.unpack_from("<I", buf, body_end)
    if native.crc32(buf[:body_end]) != crc:
        raise CodecError("fused sparse frame checksum mismatch")
    off = 8
    for _ in range(nbuckets):
        if body_end < off + 4:
            raise CodecError("fused sparse frame truncated at bucket header")
        (k,) = struct.unpack_from("<I", buf, off)
        off += 4
        if k > total:
            raise CodecError(
                f"fused sparse bucket claims {k} entries in {total} slots"
            )
        idx_bytes = buf[off : off + min(4 * k, body_end - off)]
        if len(idx_bytes) != 4 * k:
            raise CodecError("fused sparse frame truncated in indices")
        idx = np.frombuffer(idx_bytes, dtype=np.uint32)
        off += 4 * k
        if k and int(idx.max()) >= total:
            raise CodecError("fused sparse index out of range")
        if body_end < off + 4:
            raise CodecError("fused sparse frame truncated at value header")
        (vlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + vlen > body_end:
            raise CodecError("fused sparse frame truncated in values")
        try:
            vals = decode_tensor(buf[off : off + vlen])
        except (ValueError, struct.error) as exc:
            raise CodecError(str(exc)) from None
        off += vlen
        if vals.shape != (k,):
            raise CodecError(
                f"fused sparse value count {vals.shape} != {k}"
            )
        yield idx, vals
    if off != body_end:
        raise CodecError("fused sparse frame section out of bounds")


def _decode_fused_sparse_py(buf: bytes, nbuckets: int, total: int,
                            out: "np.ndarray" = None) -> np.ndarray:
    """The authoritative Python decode (header pre-parsed): crc first,
    then per-section bounds checks, then the scatter.  ``out`` (when
    given) is zero-filled first so dirty scratch never leaks."""
    if out is None:
        out = np.zeros(total, np.float32)
    else:
        out.fill(0.0)
    for idx, vals in _iter_fused_sections(buf, nbuckets, total):
        out[idx] = vals.astype(np.float32)
    return out


def decode_fused_apply(buf: bytes, target: np.ndarray, *,
                       scale: float = 1.0) -> np.ndarray:
    """Scatter-ADD a fused sparse frame straight into a live f32 ravel
    (``target[idx] += scale * vals``) with NO dense intermediate — the
    fused consume primitive for CHOCO hat updates.

    For the duplicate-free frames the encoder produces the result is
    ulp-identical to ``target += scale * decode_fused_sparse(buf)``
    (untouched positions keep their exact bytes, which the dense form
    only perturbs at ``-0.0``).  Corruption discipline is strict on BOTH
    paths here: the whole frame is validated before the first add, so a
    :class:`CodecError` guarantees ``target`` is untouched — required,
    since the target is live state, not scratch.  Returns ``target``."""
    nbuckets, total = _parse_fused_header(buf)
    _check_out(target, total)
    scale = float(scale)
    eng = _wire_engine()
    if eng is not None:
        status = eng.decode_apply(buf, target, scale)
        if status == 0:
            return target
        if status != native_wire.ERR_UNSUPPORTED:
            raise CodecError(
                native_wire.CORRUPT_MESSAGES.get(
                    status, f"wire status {status}"
                )
            )
    # Python oracle: materialize (and thereby validate) EVERY section
    # before the first add — a corrupt later bucket must not leave a
    # half-applied update in live state.
    sections = list(_iter_fused_sections(buf, nbuckets, total))
    s = np.float32(scale)
    for idx, vals in sections:
        np.add.at(target, idx, s * vals.astype(np.float32))
    return target


# --------------------------------------------------------------------- #
# Lazy receive payloads (zero-copy wire path)                            #
#                                                                        #
# The comm layer unpacks message bodies on the mux task, but the scratch #
# ravel a frame should decode into is owned by the ROUND task (the       #
# runner's per-edge scratch pool).  These wrappers split the pipeline:   #
# construction VALIDATES the frame (corruption still raises CodecError   #
# at unpack time, preserving the mux drop discipline) but defers the     #
# O(total) densify/apply to the consumer, which passes its own ``out=``  #
# scratch or applies the frame in place.                                 #
# --------------------------------------------------------------------- #
class DenseFrame:
    """A validated, not-yet-decoded dense tensor frame.

    Construction is O(1) (header + length checks); :meth:`densify` runs
    the conversion, into ``out=`` scratch when given."""

    __slots__ = ("buf", "shape", "size")

    def __init__(self, buf: bytes):
        _code, _flags, dims, _dtype, _scale, _off, count, _data = \
            _parse_tensor(buf)
        self.buf = buf
        self.shape = tuple(dims)
        self.size = count

    def densify(self, out: "np.ndarray" = None) -> np.ndarray:
        return decode_tensor(self.buf, out=out)

    def __array__(self, dtype=None, copy=None):
        dense = self.densify()
        return dense if dtype is None else dense.astype(dtype)


class SparseFrame:
    """A validated sparse frame whose O(k) parse (indices + values) ran
    at construction; only the O(total) densification is deferred."""

    __slots__ = ("shape", "size", "idx", "vals")

    def __init__(self, buf: bytes):
        dims, count, idx, vals = _parse_sparse(buf)
        self.shape = tuple(dims)
        self.size = count
        self.idx = idx
        self.vals = vals

    def densify(self, out: "np.ndarray" = None) -> np.ndarray:
        if out is not None:
            _check_out(out, self.size)
            out.fill(0.0)
            out[self.idx] = self.vals
            return out.reshape(self.shape)
        dense = np.zeros(self.size, dtype=self.vals.dtype)
        dense[self.idx] = self.vals
        return dense.reshape(self.shape)

    def __array__(self, dtype=None, copy=None):
        dense = self.densify()
        return dense if dtype is None else dense.astype(dtype)


class FusedFrame:
    """A validated, not-yet-densified fused sparse frame.

    Construction runs the full decode-side validation walk (crc +
    section geometry + dtype support + index range — native
    ``dlt_wire_fused_validate`` when available, the Python walk
    otherwise) so a corrupt frame raises :class:`CodecError` at unpack
    time and the transport drops it; the frame then densifies into
    caller scratch (:meth:`densify`) or scatter-adds straight into live
    state (:meth:`apply_into`) with no dense intermediate."""

    __slots__ = ("buf", "nbuckets", "size")

    def __init__(self, buf: bytes):
        self.nbuckets, self.size = _parse_fused_header(buf)
        eng = _wire_engine()
        status = (
            eng.validate_fused(buf, self.size)
            if eng is not None else native_wire.ERR_UNSUPPORTED
        )
        if status not in (0, native_wire.ERR_UNSUPPORTED):
            raise CodecError(
                native_wire.CORRUPT_MESSAGES.get(
                    status, f"wire status {status}"
                )
            )
        if status != 0:
            # No native engine (or a value dtype it does not speak):
            # the Python walk is the validating authority.
            for _idx, _vals in _iter_fused_sections(
                buf, self.nbuckets, self.size
            ):
                pass
        self.buf = buf

    @property
    def shape(self):
        return (self.size,)

    def densify(self, out: "np.ndarray" = None) -> np.ndarray:
        return decode_fused_sparse(self.buf, out=out)

    def apply_into(self, target: np.ndarray, *,
                   scale: float = 1.0) -> np.ndarray:
        return decode_fused_apply(self.buf, target, scale=scale)

    def __array__(self, dtype=None, copy=None):
        dense = self.densify()
        return dense if dtype is None else dense.astype(dtype)


def top_k_sparse(v: "np.ndarray", k: int):
    """Indices (ascending, uint32) and values of the k largest-|v| entries
    — the host-side selection for sparse-wire corrections.

    Deterministic: magnitude ties at the k-th boundary go to the LOWEST
    indices; NaN magnitudes count as above-threshold (a NaN-poisoned
    correction should be loud, not dropped).  Implementation is numpy
    introselect (``argpartition``) + a threshold sweep; a g++ -O3
    ``nth_element`` version was measured 2.3x SLOWER at n=36M (numpy's
    partition is simply better optimized), so unlike bf16/crc32 this op
    intentionally has no native-codec path.
    """
    v = np.ascontiguousarray(v, dtype=np.float32).ravel()
    k = int(k)
    if k <= 0 or v.size == 0:
        return np.empty(0, np.uint32), np.empty(0, np.float32)
    k = min(k, v.size)
    mag = np.abs(v)
    part = np.argpartition(mag, v.size - k)
    thresh = mag[part[v.size - k]]
    above = np.flatnonzero((mag > thresh) | np.isnan(mag))
    if above.size >= k:
        sel = above[:k]
    else:
        ties = np.flatnonzero(mag == thresh)
        sel = np.concatenate([above, ties[: k - above.size]])
        sel.sort()
    sel = sel.astype(np.uint32)
    return sel, v[sel]
