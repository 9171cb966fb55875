"""Build and load the port's CUDA kernels (``csrc/flash_attention.cu``)
through ctypes.

The source is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``distributed_learning_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name that carries a hash of the source, so an edited kernel is
rebuilt and a stale library is never loaded.  The C entry points take
plain pointers and the stream as ``ctypes.c_void_p`` and return
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

Nothing here runs at import: the CPU tests import every module of the
package on a host that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ["FlashParams", "BUILD_DIR", "check", "load_library"]

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "flash_attention.cu"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIB: Optional[ctypes.CDLL] = None


class FlashParams(ctypes.Structure):
    """Field-for-field mirror of ``struct FlashParams`` in
    ``csrc/flash_attention.cu``."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("lse", ctypes.c_void_p),
        ("dout", ctypes.c_void_p),
        ("dadj", ctypes.c_void_p),
        ("dq", ctypes.c_void_p),
        ("dk", ctypes.c_void_p),
        ("dv", ctypes.c_void_p),
        ("q_sb", ctypes.c_int64), ("q_st", ctypes.c_int64), ("q_sh", ctypes.c_int64),
        ("k_sb", ctypes.c_int64), ("k_st", ctypes.c_int64), ("k_sh", ctypes.c_int64),
        ("v_sb", ctypes.c_int64), ("v_st", ctypes.c_int64), ("v_sh", ctypes.c_int64),
        ("B", ctypes.c_int32),
        ("H", ctypes.c_int32),
        ("T", ctypes.c_int32),
        ("D", ctypes.c_int32),
        ("scale", ctypes.c_float),
        ("causal", ctypes.c_int32),
        ("window", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
    ]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are built "
        "on the machine with the card"
    )


def _build() -> Path:
    """The library's path, compiled first if no build of this source
    exists.  It is written to a temporary name and renamed, so an
    interrupted build never leaves a truncated file."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libflash_attention-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {SOURCE.name}:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build()))
    for fn in ("dlt_flash_fwd", "dlt_flash_bwd_dq", "dlt_flash_bwd_dkv"):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.POINTER(FlashParams), ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.dlt_flash_struct_size.argtypes = []
    lib.dlt_flash_struct_size.restype = ctypes.c_int
    size = lib.dlt_flash_struct_size()
    if size != ctypes.sizeof(FlashParams):
        raise RuntimeError(
            f"FlashParams layout mismatch: C {size} bytes, ctypes "
            f"{ctypes.sizeof(FlashParams)} bytes"
        )
    _LIB = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
