"""The port's wire codec (``distributed_learning_tpu_torch.comm.tensor_codec``
and ``native/``) against the JAX package's, mirroring ``tests/test_wire.py``.

Every frame the port encodes must equal the JAX package's byte for byte,
on the native engine and on the numpy path (``DLT_NO_NATIVE=1``, read on
every call), and each package must decode the other's frames.  Corrupt
frames must be rejected by both alike, and a rejected
``decode_fused_apply`` must leave its target untouched.  The build
hardening (ABI check, stale-library rebuild, a failed build's warning and
counter) runs on a ``tmp_path`` build directory.
"""

import ctypes
import os
import re
import struct
import subprocess
import zlib

import ml_dtypes
import numpy as np
import pytest

from distributed_learning_tpu import native as r_native
from distributed_learning_tpu.comm import tensor_codec as r_tc
from distributed_learning_tpu.comm.faults import FaultPlan
from distributed_learning_tpu_torch import native as p_native
from distributed_learning_tpu_torch.comm import framing as p_framing
from distributed_learning_tpu_torch.comm import protocol as p_protocol
from distributed_learning_tpu_torch.comm import tensor_codec as p_tc
from distributed_learning_tpu_torch.native import wire as p_wire
from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO, "distributed_learning_tpu_torch", "native")
PACKAGES = {"port": p_tc, "reference": r_tc}


def _have_gxx() -> bool:
    try:
        subprocess.run(["g++", "--version"], capture_output=True, timeout=30)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


@pytest.fixture(scope="module", autouse=True)
def _reference_codec_loaded():
    """The JAX package decides once per process whether its element codec
    is native, at its first call; make that call with the switch off, so
    this file's ``DLT_NO_NATIVE=1`` cases cannot turn it off for later
    tests in the same process."""
    saved = os.environ.pop("DLT_NO_NATIVE", None)
    try:
        r_native.native_available()
    finally:
        if saved is not None:
            os.environ["DLT_NO_NATIVE"] = saved


@pytest.fixture(params=["native", "python"])
def wire_path(request, monkeypatch):
    """Each case on the native engines and on the numpy path."""
    if request.param == "native":
        monkeypatch.delenv("DLT_NO_NATIVE", raising=False)
        if not p_wire.available():
            pytest.skip("the port's native wire engine did not build here")
    else:
        monkeypatch.setenv("DLT_NO_NATIVE", "1")
    return request.param


def _sparsify(rng, dense, keep=0.1):
    return np.where(rng.random(dense.size) < keep, dense, 0.0).astype(np.float32)


def _scenarios():
    """(name, flat, buckets): the fused-frame shapes of tests/test_wire.py."""
    rng = np.random.default_rng(42)
    z = np.zeros(64, np.float32)
    z[50] = 1.5
    return [
        ("mixed", _sparsify(rng, rng.normal(size=4096).astype(np.float32)),
         (("bfloat16", ((0, 1024), (3072, 512))), ("float32", ((1024, 2048), (3584, 512))))),
        ("f16_origin", _sparsify(rng, rng.normal(size=256).astype(np.float32)),
         (("float16", ((0, 128),)), ("float32", ((128, 128),)))),
        ("empty_bucket", z, (("bfloat16", ()), ("float32", ((0, 32), (32, 32))))),
        ("zero_tree", np.zeros(0, np.float32), ()),
        ("all_dense", rng.normal(size=512).astype(np.float32) + 0.25,
         (("float32", ((0, 512),)),)),
    ]


_MODES = [{}, {"bf16_wire": True}, {"int8_wire": True}]
_MODE_IDS = ["plain", "bf16", "int8"]


def _outcome(fn, *args, **kw):
    """("ok", result bytes) or ("error", exception class name, message)."""
    try:
        out = fn(*args, **kw)
    except (ValueError, struct.error) as exc:
        return ("error", type(exc).__name__, str(exc))
    return ("ok", np.asarray(out).tobytes(), np.asarray(out).shape)


# --------------------------------------------------------------------- #
# Frames byte for byte                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,flat,buckets", _scenarios(), ids=[s[0] for s in _scenarios()])
@pytest.mark.parametrize("mode", _MODES, ids=_MODE_IDS)
def test_fused_frames_equal_the_reference_and_cross_decode(wire_path, name, flat, buckets, mode):
    frame = p_tc.encode_fused_sparse(flat, buckets, **mode)
    ref = r_tc.encode_fused_sparse(flat, buckets, **mode)
    modes = p_tc._bucket_modes(tuple(buckets), mode.get("bf16_wire", False),
                               mode.get("int8_wire", False))
    assert frame == ref == p_tc._encode_fused_sparse_py(flat, tuple(buckets), modes)
    dec = p_tc.decode_fused_sparse(ref)
    np.testing.assert_array_equal(dec, r_tc.decode_fused_sparse(frame))
    np.testing.assert_array_equal(dec, p_tc._decode_fused_sparse_py(frame, len(buckets),
                                                                     flat.size))
    if not mode:  # f32 sections exact, bf16-origin sections the RNE narrowing
        for bname, spans in buckets:
            for off, size in spans:
                seg = flat[off:off + size]
                want = seg
                if bname in p_tc._BF16_ORIGIN:
                    want = seg.astype(ml_dtypes.bfloat16).astype(np.float32)
                np.testing.assert_array_equal(dec[off:off + size], want)


def test_fused_nan_payload_survives_bf16_and_refuses_int8(wire_path):
    flat = np.zeros(128, np.float32)
    flat[3], flat[77] = np.nan, 2.0
    buckets = (("bfloat16", ((0, 64),)), ("float32", ((64, 64),)))
    for kw in ({}, {"bf16_wire": True}):
        frame = p_tc.encode_fused_sparse(flat, buckets, **kw)
        assert frame == r_tc.encode_fused_sparse(flat, buckets, **kw)
        out = p_tc.decode_fused_sparse(frame)
        assert np.isnan(out[3]) and out[77] == 2.0
    for poison in (np.nan, np.inf):
        flat[3] = poison
        with pytest.raises(p_tc.CodecError, match="finite"):
            p_tc.encode_fused_sparse(flat, buckets, int8_wire=True)


@pytest.mark.parametrize("shape", [(), (0,), (7,), (64, 33), (2, 3, 4)],
                         ids=["0d", "empty", "vec", "mat", "3d"])
@pytest.mark.parametrize("mode", _MODES, ids=_MODE_IDS)
def test_dense_frames_equal_the_reference_on_both_paths(wire_path, monkeypatch, shape, mode):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    frame = p_tc.encode_tensor(x, **mode)
    assert frame == r_tc.encode_tensor(x, **mode)
    monkeypatch.setenv("DLT_NO_NATIVE", "1")
    assert p_tc.encode_tensor(x, **mode) == frame
    decoded_py = p_tc.decode_tensor(frame)
    monkeypatch.delenv("DLT_NO_NATIVE")
    np.testing.assert_array_equal(p_tc.decode_tensor(frame), decoded_py)
    np.testing.assert_array_equal(r_tc.decode_tensor(frame), decoded_py)


def test_other_dtypes_and_sparse_frames_equal_the_reference(wire_path):
    rng = np.random.default_rng(3)
    for arr in (np.arange(12, dtype=np.int32).reshape(3, 4), np.asarray([True, False, True]),
                np.linspace(0, 1, 9, dtype=np.float64), np.arange(5, dtype=np.int64),
                np.arange(6, dtype=np.uint8), np.arange(4, dtype=np.uint16),
                np.arange(-3, 3, dtype=np.int8)):
        frame = p_tc.encode_tensor(arr)
        assert frame == r_tc.encode_tensor(arr)
        out = p_tc.decode_tensor(frame)
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(out, arr)
    dense = np.zeros((64, 32), np.float32)
    dense.ravel()[rng.choice(dense.size, 64, replace=False)] = rng.normal(size=64)
    for mode in _MODES:
        frame = p_tc.encode_sparse(dense, **mode)
        assert frame == r_tc.encode_sparse(dense, **mode)
        np.testing.assert_array_equal(p_tc.decode_sparse(frame), r_tc.decode_sparse(frame))
        scratch = np.full(dense.size, np.nan, np.float32)
        np.testing.assert_array_equal(p_tc.decode_sparse(frame, out=scratch),
                                      r_tc.decode_sparse(frame).astype(np.float32))
    assert p_tc.encode_sparse(np.float32(2.5)) == r_tc.encode_sparse(np.float32(2.5))


def test_python_bf16_rounding_equals_ml_dtypes():
    """The port's numpy float32 -> bfloat16 (no ml_dtypes on the card's
    machine) gives ml_dtypes' bits for every class of input: random bit
    patterns (NaNs, infinities, subnormals, ties) and the specials."""
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, size=1 << 18, dtype=np.uint32),
        np.asarray([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7F7FFFFF, 0x7F7F8000,
                    0x00008000, 0x00018000, 0x3F808000, 0x3F818000, 0x7FC00001,
                    0xFFA00000], np.uint32)])
    x = bits.view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(p_native._bf16_bits_py(x), want)
    b16 = rng.integers(0, 2 ** 16, size=1 << 16, dtype=np.uint64).astype(np.uint16)
    os.environ["DLT_NO_NATIVE"] = "1"
    try:
        got = p_native.bf16_to_f32(b16)
    finally:
        del os.environ["DLT_NO_NATIVE"]
    np.testing.assert_array_equal(got.view(np.uint32),
                                  b16.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


def test_element_codec_paths_agree_and_crc_is_zlib(monkeypatch):
    rng = np.random.default_rng(8)
    x = rng.normal(size=4097).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    scale = float(np.abs(x[4:]).max() / 127.0)
    data = rng.bytes(65537)
    served = (p_native.f32_to_bf16(x), p_native.f32_to_i8(x[4:], scale), p_native.crc32(data))
    monkeypatch.setenv("DLT_NO_NATIVE", "1")
    numpy_path = (p_native.f32_to_bf16(x), p_native.f32_to_i8(x[4:], scale),
                  p_native.crc32(data))
    for a, b in zip(served[:2], numpy_path[:2]):
        np.testing.assert_array_equal(a, b)
    assert served[2] == numpy_path[2] == zlib.crc32(data) & 0xFFFFFFFF
    assert p_native.crc32(b"") == 0


def test_wire_gauge_records_serving_path(monkeypatch):
    flat = np.asarray([1.0, 0.0, 2.0], np.float32)
    buckets = (("float32", ((0, 3),)),)
    reg = MetricsRegistry()
    with use_registry(reg):
        p_tc.encode_fused_sparse(flat, buckets)
    assert reg.snapshot()["gauges"]["comm.wire.native"] == (1.0 if p_wire.available() else 0.0)
    monkeypatch.setenv("DLT_NO_NATIVE", "1")
    reg2 = MetricsRegistry()
    with use_registry(reg2):
        p_tc.encode_fused_sparse(flat, buckets)
    assert reg2.snapshot()["gauges"]["comm.wire.native"] == 0.0


# --------------------------------------------------------------------- #
# out= scratch, fused apply, lazy frames                                #
# --------------------------------------------------------------------- #
def test_decode_out_matches_alloc_path_and_the_reference(wire_path):
    for name, flat, buckets in _scenarios():
        for mode in _MODES:
            frame = p_tc.encode_fused_sparse(flat, buckets, **mode)
            ref = r_tc.decode_fused_sparse(frame)
            scratch = np.full(flat.size, np.nan, np.float32)
            got = p_tc.decode_fused_sparse(frame, out=scratch)
            assert got is scratch
            np.testing.assert_array_equal(got, ref, err_msg=(name, mode))
    rng = np.random.default_rng(18)
    for shape in [(), (0,), (7,), (64, 33), (2, 3, 4)]:
        x = rng.normal(size=shape).astype(np.float32)
        for mode in _MODES:
            frame = p_tc.encode_tensor(x, **mode)
            scratch = np.full(max(x.size, 1) if shape == () else x.size, np.nan, np.float32)
            got = p_tc.decode_tensor(frame, out=scratch)
            assert got.shape == x.shape and (np.shares_memory(got, scratch) or x.size == 0)
            np.testing.assert_array_equal(got, r_tc.decode_tensor(frame))


def test_decode_out_contract_rejects_bad_scratch(wire_path):
    flat = np.asarray([0.0, 1.0, 0.0, -2.0], np.float32)
    frame = p_tc.encode_fused_sparse(flat, (("float32", ((0, 4),)),))
    frozen = np.zeros(4, np.float32)
    frozen.setflags(write=False)
    for bad, match in ((np.zeros(3, np.float32), "elements"),
                       (np.zeros(4, np.float64), "float32"),
                       (np.zeros(8, np.float32)[::2], "contiguous"),
                       (frozen, "writ"), ([0.0] * 4, "ndarray")):
        with pytest.raises(ValueError, match=match):
            p_tc.decode_fused_sparse(frame, out=bad)
        with pytest.raises(ValueError, match=match):
            p_tc.decode_fused_apply(frame, bad)


def test_fused_apply_equals_reference_and_keeps_untouched_bytes(wire_path):
    for name, flat, buckets in _scenarios():
        for mode in _MODES:
            frame = p_tc.encode_fused_sparse(flat, buckets, **mode)
            dense = p_tc.decode_fused_sparse(frame)
            base = np.random.default_rng(5).normal(size=flat.size).astype(np.float32)
            zeros = np.flatnonzero((dense == 0) & (flat == 0))
            if zeros.size:
                base[zeros[0]] = np.float32(-0.0)
            target = base.copy()
            got = p_tc.decode_fused_apply(frame, target, scale=0.5)
            assert got is target
            want = r_tc.decode_fused_apply(frame, base.copy(), scale=0.5)
            assert got.tobytes() == want.tobytes(), (name, mode)
            np.testing.assert_array_equal(got, base + np.float32(0.5) * dense)
            if zeros.size:
                assert np.signbit(got[zeros[0]])


def test_lazy_frames_validate_at_construction(wire_path):
    rng = np.random.default_rng(21)
    flat = _sparsify(rng, rng.normal(size=512).astype(np.float32))
    buckets = (("bfloat16", ((0, 256),)), ("float32", ((256, 256),)))
    frame = p_tc.encode_fused_sparse(flat, buckets, bf16_wire=True)
    lazy = p_tc.FusedFrame(frame)
    assert lazy.size == 512 and lazy.shape == (512,)
    ref = r_tc.decode_fused_sparse(frame)
    np.testing.assert_array_equal(lazy.densify(out=np.full(512, np.nan, np.float32)), ref)
    base = rng.normal(size=512).astype(np.float32)
    target = base.copy()
    lazy.apply_into(target, scale=0.25)
    np.testing.assert_array_equal(target, r_tc.decode_fused_apply(frame, base.copy(), scale=0.25))
    np.testing.assert_array_equal(np.asarray(lazy), ref)
    b = bytearray(frame)
    b[12:16] = struct.pack("<I", 0xFFFFFFFF)
    for bad in (_recrc(bytes(b)), frame[: len(frame) // 2]):
        with pytest.raises(p_tc.CodecError):
            p_tc.FusedFrame(bad)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    dframe = p_tc.encode_tensor(x, bf16_wire=True)
    dlazy = p_tc.DenseFrame(dframe)
    assert dlazy.shape == (16, 8) and dlazy.size == 128
    np.testing.assert_array_equal(dlazy.densify(out=np.full(128, np.nan, np.float32)),
                                  r_tc.decode_tensor(dframe))
    sframe = p_tc.encode_sparse(flat)
    slazy = p_tc.SparseFrame(sframe)
    np.testing.assert_array_equal(slazy.densify(), r_tc.decode_sparse(sframe))


# --------------------------------------------------------------------- #
# Corrupt frames: both packages reject alike                            #
# --------------------------------------------------------------------- #
def _recrc(frame: bytes) -> bytes:
    body = frame[:-4]
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def _base_frames():
    rng = np.random.default_rng(1234)
    frames = []
    for total, buckets in [(256, (("bfloat16", ((0, 128),)), ("float32", ((128, 128),)))),
                           (64, (("float32", ((0, 64),)),))]:
        flat = _sparsify(rng, rng.normal(size=total).astype(np.float32), keep=0.3)
        for kw in ({}, {"bf16_wire": True}, {"int8_wire": True}):
            frames.append((p_tc.encode_fused_sparse(flat, buckets, **kw), flat))
    return frames


def _mutants(n=200, seed=99):
    """Truncations, bit flips and crc-clean stomps of a u32 in the
    section area (tests/test_wire.py's corpus), plus the fault harness's
    two wire mutations of every base frame."""
    rng = np.random.default_rng(seed)
    frames = _base_frames()
    out = []
    plan = FaultPlan(seed=4242)
    for i, (frame, flat) in enumerate(frames):
        out.append((plan.corrupt_bytes(i, frame), flat.size))
        out.append((_recrc(plan.truncate_bytes(i, frame[:-4])), flat.size))
    while len(out) < n:
        frame, flat = frames[int(rng.integers(len(frames)))]
        roll = int(rng.integers(3))
        b = bytearray(frame)
        if roll == 0:
            mutant = frame[: int(rng.integers(0, len(frame)))]
        elif roll == 1:
            b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
            mutant = bytes(b)
        else:
            pos = int(rng.integers(8, len(b) - 8))
            val = int(rng.choice([0xFFFFFFFF, 0x7FFFFFFF, len(b) * 2, int(flat.size), 1 << 28]))
            b[pos:pos + 4] = struct.pack("<I", val)
            mutant = _recrc(bytes(b))
        out.append((mutant, flat.size))
    return out


def test_corrupt_frames_rejected_by_both_packages_alike(wire_path):
    rejected = 0
    for mutant, total in _mutants():
        port = _outcome(p_tc.decode_fused_sparse, mutant)
        assert port == _outcome(r_tc.decode_fused_sparse, mutant)
        rejected += port[0] == "error"
        assert (_outcome(p_tc.FusedFrame, mutant)[0] == "error") == (port[0] == "error")
        target = np.random.default_rng(total).normal(size=total).astype(np.float32)
        before = target.tobytes()
        applied = _outcome(p_tc.decode_fused_apply, mutant, target, scale=0.5)
        assert applied == _outcome(r_tc.decode_fused_apply, mutant,
                                   np.frombuffer(before, np.float32).copy(), scale=0.5)
        if applied[0] == "error":
            assert target.tobytes() == before, "a rejected apply wrote into its target"
    assert rejected >= 150


def test_adversarial_sections_raise_bounds_not_write(wire_path):
    flat = np.zeros(32, np.float32)
    flat[[1, 9, 30]] = [1.0, -2.0, 3.0]
    frame = p_tc.encode_fused_sparse(flat, (("float32", ((0, 32),)),))
    cases = []
    b = bytearray(frame)
    b[8:12] = struct.pack("<I", 1000)                  # k past the ravel
    cases.append((_recrc(bytes(b)), None))
    b = bytearray(frame)
    b[12:16] = struct.pack("<I", 32)                   # index one past the end
    cases.append((_recrc(bytes(b)), "range"))
    b = bytearray(frame)
    b[24:28] = struct.pack("<I", 5)                    # a value length that lies
    cases.append((_recrc(bytes(b)), None))
    cases.append((_recrc(frame[:-4] + b"\x00\x00" + frame[-4:]), None))   # slack
    v0 = bytearray(frame)
    v0[1] = 0
    cases.append((_recrc(bytes(v0)), "version"))
    huge = struct.pack("<BBBBI", 0xFE, 1, 1, 0, 1 << 31) + struct.pack("<I", 0)
    cases.append((huge, "densifies"))
    for bad, match in cases:
        for tc in (p_tc, r_tc):
            with pytest.raises(tc.CodecError, match=match):
                tc.decode_fused_sparse(bad)
            target = np.arange(32, dtype=np.float32)
            with pytest.raises(ValueError):
                tc.decode_fused_apply(bad, target)
            np.testing.assert_array_equal(target, np.arange(32, dtype=np.float32))


def test_unsupported_value_dtype_falls_back_to_the_python_oracle(wire_path):
    idx = np.asarray([2, 5], np.uint32)
    vframe = r_tc.encode_tensor(np.asarray([1.5, -2.5], np.float64))
    body = (struct.pack("<BBBBI", 0xFE, 1, 1, 0, 8) + struct.pack("<I", 2) + idx.tobytes()
            + struct.pack("<I", len(vframe)) + vframe)
    frame = body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
    np.testing.assert_array_equal(p_tc.decode_fused_sparse(frame),
                                  np.asarray([0, 0, 1.5, 0, 0, -2.5, 0, 0], np.float32))
    np.testing.assert_array_equal(p_tc.FusedFrame(frame).densify(),
                                  r_tc.decode_fused_sparse(frame))


# --------------------------------------------------------------------- #
# The wire identity and the build                                       #
# --------------------------------------------------------------------- #
def test_wire_versions_agree_across_python_and_cpp():
    abi = open(os.path.join(NATIVE_DIR, "dlt_abi.h")).read()
    cpp = open(os.path.join(NATIVE_DIR, "wire.cpp")).read()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)u", abi).group(1))

    def constexpr(name):
        return int(re.search(rf"constexpr uint8_t {name} = (\d+);", cpp).group(1))

    assert define("DLT_ABI_VERSION") == p_native._ABI_VERSION == r_native._ABI_VERSION
    assert define("DLT_WIRE_VERSION") == constexpr("kWireVersion") == p_framing.WIRE_VERSION
    assert (define("DLT_TRACE_CTX_VERSION") == constexpr("kTraceCtxVersion")
            == p_protocol.TRACE_CTX_VERSION)
    assert constexpr("kFusedVersion") == p_tc._FUSED_VERSION == r_tc._FUSED_VERSION
    assert p_tc._DTYPE_CODES == r_tc._DTYPE_CODES


def test_abi_version_of_the_loaded_libraries(monkeypatch):
    monkeypatch.delenv("DLT_NO_NATIVE", raising=False)
    if not p_wire.available():
        pytest.skip("the port's native wire engine did not build here")
    for lib in (p_native._load(), p_wire._load()):
        fn = lib.dlt_abi_version
        fn.restype = ctypes.c_uint32
        assert int(fn()) == p_native._ABI_VERSION
    for src in (p_native._SRC, p_wire._SRC):
        path = p_native.library_path(src)
        assert os.path.dirname(path) == str(p_native.BUILD_DIR)
        assert os.path.exists(path)
    tracked = subprocess.run(["git", "ls-files", "distributed_learning_tpu_torch/"], cwd=REPO,
                             capture_output=True, text=True).stdout
    assert ".so" not in tracked
    assert sorted(os.listdir(NATIVE_DIR)) == sorted(
        n for n in os.listdir(NATIVE_DIR) if not n.endswith((".so", ".tmp")))


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    monkeypatch.setenv("DLT_NATIVE_CACHE_DIR", str(tmp_path))
    path = p_native.library_path(p_wire._SRC)
    assert os.path.dirname(path) == str(tmp_path)
    assert re.fullmatch(r"_wire-[0-9a-f]{16}\.so", os.path.basename(path))
    assert path != p_native.library_path(p_native._SRC)


def test_stale_library_is_rebuilt_not_served(tmp_path):
    if not _have_gxx():
        pytest.skip("no g++ in this environment")
    src = tmp_path / "mini.cpp"
    src.write_text('#include <cstdint>\nextern "C" { uint32_t dlt_abi_version() { return %du; }\n'
                   "int dlt_mini_marker() { return 7; } }\n" % p_native._ABI_VERSION)
    stale_src = tmp_path / "stale.cpp"
    stale_src.write_text('extern "C" { int old_symbol() { return 1; } }\n')
    lib_path = tmp_path / "_mini-0000000000000000.so"
    subprocess.run(["g++", "-O0", "-shared", "-fPIC", str(stale_src), "-o", str(lib_path)],
                   check=True, capture_output=True, timeout=120)
    lib = p_native._load_lib(str(src), str(lib_path), lambda lib: None)
    assert lib is not None, "a library without the ABI symbol must be rebuilt, not served"
    lib.dlt_mini_marker.restype = ctypes.c_int
    assert lib.dlt_mini_marker() == 7


def test_wrong_abi_after_rebuild_falls_back_with_counter(tmp_path):
    if not _have_gxx():
        pytest.skip("no g++ in this environment")
    src = tmp_path / "wrong.cpp"
    src.write_text('#include <cstdint>\nextern "C" { uint32_t dlt_abi_version() { return 424242u; } }\n')
    reg = MetricsRegistry()
    with use_registry(reg):
        lib = p_native._load_lib(str(src), str(tmp_path / "_wrong.so"), lambda lib: None)
    assert lib is None
    assert reg.snapshot()["counters"]["native.build_failed"] == 1


def test_failed_build_warns_and_bumps_counter(tmp_path, caplog):
    if not _have_gxx():
        pytest.skip("no g++ in this environment")
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    reg = MetricsRegistry()
    with caplog.at_level("WARNING", logger="dlt.native"), use_registry(reg):
        out = p_native._build_lib(str(src), str(tmp_path / "_broken.so"))
    assert out is None
    assert reg.snapshot()["counters"]["native.build_failed"] == 1
    assert any("native build" in r.message for r in caplog.records)
    assert not os.path.exists(tmp_path / "_broken.so")
