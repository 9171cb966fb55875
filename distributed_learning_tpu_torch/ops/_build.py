"""Build and load the port's CUDA kernels (``csrc/*.cu``) through ctypes.

The sources are compiled at first use, one ``nvcc`` per ``.cu``, all
started together, then linked into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c <source>.cu
    nvcc -shared <objects> -o libdlt_flash-<hash>.so

into ``distributed_learning_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name that carries a hash of every file under ``csrc/`` (sources
and headers), so an edited kernel or header is rebuilt and a stale library
is never loaded.  ptxas's report (registers, spills, shared memory of each
kernel) is kept beside the library as ``<name>.ptxas.txt``.  The C entry
points take plain pointers and the stream as ``ctypes.c_void_p`` and return
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
from typing import List, Optional

__all__ = ["FlashParams", "BUILD_DIR", "CSRC", "check", "library_path", "load_library",
           "ptxas_report"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target.
# -Xptxas=-v reports each kernel's registers and spills.  No -lcuda and no
# CUTLASS include: the TMA maps are encoded through the runtime's driver
# entry point (cudaGetDriverEntryPoint), and the PTX is written by hand.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_ENTRIES = ("dlt_flash_fwd", "dlt_flash_bwd_dq", "dlt_flash_bwd_dkv", "dlt_flash_bwd_rowterm")

_LIB: Optional[ctypes.CDLL] = None


class FlashParams(ctypes.Structure):
    """Field-for-field mirror of ``struct FlashParams`` in
    ``csrc/flash_params.cuh``."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("lse", ctypes.c_void_p),
        ("dout", ctypes.c_void_p),
        ("dadj", ctypes.c_void_p),
        ("rowterm", ctypes.c_void_p),
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


def _sources() -> List[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library built from the current ``csrc/`` lives: its name
    hashes every source and header, name and content."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return BUILD_DIR / f"libdlt_flash-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library's path, compiled first if no build of these sources
    exists.  It is linked to a temporary name and renamed, so an
    interrupted build never leaves a truncated file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cus]
    procs = [
        (src, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src, obj in zip(cus, objs)
    ]
    reports = [(src, proc.communicate()[1], proc.returncode) for src, proc in procs]
    for src, err, code in reports:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}) for {src.name}:\n{err[-4000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    out.with_suffix(".ptxas.txt").write_text("".join(f"== {src.name}\n{err}"
                                                     for src, err, _ in reports))
    os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """ptxas's ``-v`` output for the current build ('' if it has none)."""
    path = library_path().with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build()))
    for fn in _ENTRIES:
        f = getattr(lib, fn)
        f.argtypes = [ctypes.POINTER(FlashParams), ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.dlt_flash_uses_wgmma.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dlt_flash_uses_wgmma.restype = ctypes.c_int
    lib.dlt_flash_wgmma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dlt_flash_wgmma_smem_bytes.restype = ctypes.c_int
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
