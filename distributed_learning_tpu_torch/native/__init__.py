"""Native (C++) wire codec of the port, loaded through ctypes, with
numpy versions of the same functions (port of
``distributed_learning_tpu/native/__init__.py``).

``codec.cpp`` holds the element-wise primitives (float32 <-> bfloat16,
int8 quantization, crc32); ``wire.cpp`` (wrapped by :mod:`.wire`) is the
whole-frame engine on the same primitives.  Both are the port's own
copies of the JAX package's sources: host C++, no torch and no CUDA.

Each library is compiled with ``g++ -O3 -fPIC -shared`` at first use into
``distributed_learning_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name that carries a hash of its source and ``dlt_abi.h``, so an
edited source is rebuilt and nothing is ever written beside the sources.
``DLT_NATIVE_CACHE_DIR`` puts the libraries in another directory.

Every library exports ``dlt_abi_version()`` (``dlt_abi.h``), checked
right after ``dlopen``: a library of the wrong ABI at the expected path
is rebuilt once, never served.  A failed build logs one warning on the
``dlt.native`` logger and adds one to the ``native.build_failed``
counter of the port's obs registry, and the numpy versions serve, as in
the JAX package.  ``DLT_NO_NATIVE=1`` selects the numpy versions; it is
read on every call, so a process can switch between the two paths.

The numpy versions are the byte-for-byte oracle of the native ones.
Where the JAX package's fallback converts through ``ml_dtypes`` (which
comes with JAX), the port rounds float32 to bfloat16 with integer
arithmetic on the bit patterns, with the same results (NaN to a quiet
NaN of the same sign).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

__all__ = [
    "native_available",
    "f32_to_bf16",
    "bf16_to_f32",
    "f32_to_i8",
    "i8_to_f32",
    "crc32",
    "library_path",
    "BUILD_DIR",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.cpp")
_ABI_HEADER = os.path.join(_HERE, "dlt_abi.h")
BUILD_DIR = Path(_HERE).parent / "_build"
_lock = threading.Lock()
# Loaded libraries by source path; None records a build that failed.
_libs: Dict[str, Optional[ctypes.CDLL]] = {}

#: Expected ``dlt_abi_version()`` of every native library; must match
#: DLT_ABI_VERSION in ``dlt_abi.h`` (bumped when the symbol set changes).
_ABI_VERSION = 3

_logger = logging.getLogger("dlt.native")


def disabled() -> bool:
    """``DLT_NO_NATIVE=1`` in the environment right now."""
    return os.environ.get("DLT_NO_NATIVE") == "1"


def _report_build_failure(src: str, detail: str) -> None:
    """One warning and one counter per failed build: a host quietly
    running the numpy codec is a fault to see, not a convenience."""
    _logger.warning(
        "native build of %s failed (%s); falling back to the numpy "
        "codec: wire throughput will be the fallback's",
        os.path.basename(src), detail,
    )
    from distributed_learning_tpu_torch.obs import get_registry

    get_registry().inc("native.build_failed")


def library_path(src: str) -> str:
    """Where the library built from ``src`` lives: ``_build/`` (or
    ``DLT_NATIVE_CACHE_DIR``), named after the source with a hash of it
    and of ``dlt_abi.h``."""
    h = hashlib.sha256()
    for path in (src, _ABI_HEADER):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    stem = os.path.splitext(os.path.basename(src))[0]
    return _cache_override(str(BUILD_DIR / f"_{stem}-{h.hexdigest()[:16]}.so"))


def _cache_override(lib_path: str) -> str:
    """With ``DLT_NATIVE_CACHE_DIR`` set, the built library lives under
    that directory instead."""
    cache_dir = os.environ.get("DLT_NATIVE_CACHE_DIR")
    if not cache_dir:
        return lib_path
    return os.path.join(cache_dir, os.path.basename(lib_path))


def _build_lib(src: str, lib_path: str, *, force: bool = False) -> Optional[str]:
    """Compile ``src`` to ``lib_path`` unless that file exists (its name
    carries the sources' hash).  ``force`` rebuilds (the ABI-mismatch
    path).  Returns the path, or None after a reported failure."""
    if not force and os.path.exists(lib_path):
        return lib_path
    # A temporary name per process: concurrent first-use builds must not
    # interleave output on one path; os.replace is atomic.  -march=native
    # suits a library built on the host that runs it; a toolchain that
    # refuses it gets the portable baseline.
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    last_exc: Optional[BaseException] = None
    for extra in (["-march=native"], []):
        try:
            os.makedirs(os.path.dirname(lib_path), exist_ok=True)
            subprocess.run(base[:2] + extra + base[2:], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, lib_path)
            return lib_path
        except (OSError, subprocess.SubprocessError) as exc:
            last_exc = exc
            try:
                os.unlink(tmp)
            except OSError:
                pass
    detail = type(last_exc).__name__
    stderr = getattr(last_exc, "stderr", None)
    if stderr:
        detail += ": " + stderr.decode("utf-8", "replace").strip()[:200]
    _report_build_failure(src, detail)
    return None


def _abi_ok(lib: ctypes.CDLL) -> bool:
    try:
        fn = lib.dlt_abi_version
    except AttributeError:
        return False
    fn.argtypes = []
    fn.restype = ctypes.c_uint32
    return int(fn()) == _ABI_VERSION


def _dlopen(path: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _load_lib(
    src: str,
    lib_path: str,
    configure: Callable[[ctypes.CDLL], None],
) -> Optional[ctypes.CDLL]:
    """Build (if needed), dlopen, ABI-check and configure one library.

    A library of the wrong ABI at ``lib_path`` is rebuilt once from
    ``src``; a second mismatch means the source itself disagrees with
    this loader, reported as a failed build, and the numpy path serves.
    """
    path = _build_lib(src, lib_path)
    lib = None if path is None else _dlopen(path)
    if lib is None:
        return None
    if not _abi_ok(lib):
        _logger.warning(
            "cached %s has a stale ABI (wanted v%d); rebuilding from source",
            os.path.basename(lib_path), _ABI_VERSION,
        )
        # dlopen caches by path name while a handle is open: the rebuilt
        # library would resolve to the stale image unless it is closed.
        import _ctypes

        _ctypes.dlclose(lib._handle)
        path = _build_lib(src, lib_path, force=True)
        lib = None if path is None else _dlopen(path)
        if lib is None:
            return None
        if not _abi_ok(lib):
            _report_build_failure(src, "rebuilt library still ABI-stale")
            return None
    configure(lib)
    return lib


def load(src: str, configure: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """The library of ``src``, built and loaded at its first call in
    this process, or None when ``DLT_NO_NATIVE=1`` is set now or the
    build failed."""
    if disabled():
        return None
    with _lock:
        if src not in _libs:
            _libs[src] = _load_lib(src, library_path(src), configure)
        return _libs[src]


def _configure_codec(lib: ctypes.CDLL) -> None:
    for name in ("dlt_f32_to_bf16", "dlt_bf16_to_f32"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        getattr(lib, name).restype = None
    for name in ("dlt_f32_to_i8", "dlt_i8_to_f32"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                       ctypes.c_float]
        getattr(lib, name).restype = None
    lib.dlt_crc32.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.dlt_crc32.restype = ctypes.c_uint32


def _load() -> Optional[ctypes.CDLL]:
    return load(_SRC, _configure_codec)


def native_available() -> bool:
    return _load() is not None


def _bf16_bits_py(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns, round to nearest even; a NaN
    becomes the quiet NaN of its sign (``ml_dtypes``' conversion)."""
    bits = x.view(np.uint32)
    rounded = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) >> 16)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = ((bits >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 array -> uint16 array of bfloat16 bit patterns (RNE)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    lib = _load()
    if lib is not None and x.size:
        out = np.empty(x.shape, dtype=np.uint16)
        lib.dlt_f32_to_bf16(x.ctypes.data, out.ctypes.data, ctypes.c_size_t(x.size))
        return out
    return _bf16_bits_py(x)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32 array."""
    bits = np.ascontiguousarray(bits, dtype=np.uint16)
    lib = _load()
    if lib is not None and bits.size:
        out = np.empty(bits.shape, dtype=np.float32)
        lib.dlt_bf16_to_f32(bits.ctypes.data, out.ctypes.data, ctypes.c_size_t(bits.size))
        return out
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_i8(x: np.ndarray, scale: float) -> np.ndarray:
    """Symmetric int8 quantization: round(x/scale) clamped to [-127, 127]
    (ties to even, matching np.rint).  ``scale`` is the caller's
    per-tensor max|x|/127."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    inv = 0.0 if scale == 0.0 else 1.0 / float(scale)
    lib = _load()
    if lib is not None and x.size:
        out = np.empty(x.shape, dtype=np.int8)
        lib.dlt_f32_to_i8(x.ctypes.data, out.ctypes.data, ctypes.c_size_t(x.size),
                          ctypes.c_float(inv))
        return out
    return np.clip(np.rint(x * inv), -127, 127).astype(np.int8)


def i8_to_f32(q: np.ndarray, scale: float) -> np.ndarray:
    """Dequantize int8 back to f32: q * scale."""
    q = np.ascontiguousarray(q, dtype=np.int8)
    lib = _load()
    if lib is not None and q.size:
        out = np.empty(q.shape, dtype=np.float32)
        lib.dlt_i8_to_f32(q.ctypes.data, out.ctypes.data, ctypes.c_size_t(q.size),
                          ctypes.c_float(scale))
        return out
    return q.astype(np.float32) * np.float32(scale)


def crc32(data, seed: int = 0) -> int:
    """crc32 (zlib-compatible) of a bytes-like or contiguous array."""
    lib = _load()
    if lib is not None:
        buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
        if buf.size == 0:
            return zlib.crc32(b"", seed) & 0xFFFFFFFF
        return int(lib.dlt_crc32(buf.ctypes.data, ctypes.c_size_t(buf.size),
                                 ctypes.c_uint32(seed)))
    return zlib.crc32(memoryview(data).cast("B"), seed) & 0xFFFFFFFF
