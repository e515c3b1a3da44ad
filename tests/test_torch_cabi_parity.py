"""The port's C library (libusearch_torch.so, ``USEARCH_TORCH_DEVICE=cpu``)
against the JAX package's (c/lib.cpp, built into a temporary directory with
c/Makefile's g++ line), both loaded into this process and driven with the
same calls on seeded numpy inputs: i8/ip, f32/cos, bf16/l2sq and b1/hamming
indexes with single and multi keys, 256 one-row adds each, then search,
filtered search, get (bf16 out included), contains, count, remove, rename,
clear; usearch_distance, strided usearch_exact_search and C-pointer L1
metrics with and without state; files and buffers saved by either library
loaded by the other. Keys are equal apart from ties, distances within
FLOAT_RTOL/FLOAT_ATOL (i8 cos within 4 ulps of 1). The last test fails if a
function of usearch_torch.h went uncalled."""

import ctypes
import os
import re
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from usearch_torch import cabi  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None or shutil.which("cc") is None,
                                reason="no C/C++ toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-4
#: i8 cos: the JAX package's rsqrt and FMA differ by up to ~4 ulps of 1
I8_COS_ATOL = 4 * float(np.finfo(np.float32).eps)
NDIM, BITS, ROWS, K = 32, 64, 256, 10
M, S = cabi.METRICS, cabi.SCALARS
KINDS = [("i8", "ip"), ("f32", "cos"), ("bf16", "l2sq"), ("b1", "hamming")]
LIBS = ("tpu", "torch")
CALLED = set()

_P = ctypes.POINTER
KEYS_P, DISTS_P = _P(ctypes.c_uint64), _P(ctypes.c_float)

UDF_SOURCE = r"""
#include <stdint.h>
#include <string.h>
#include <math.h>
float l1_f32(void const* a, void const* b) {
    float const *x = a, *y = b;
    float s = 0;
    for (int i = 0; i < 32; ++i) s += fabsf(x[i] - y[i]);
    return s;
}
float l1_f32_state(void const* a, void const* b, void* state) {
    float const *x = a, *y = b;
    float s = 0;
    for (int i = 0; i < *(int const*)state; ++i) s += fabsf(x[i] - y[i]);
    return s;
}
static float bf16(uint16_t bits) {
    uint32_t u = (uint32_t)bits << 16;
    float f;
    memcpy(&f, &u, 4);
    return f;
}
float l1_bf16_state(void const* a, void const* b, void* state) {
    uint16_t const *x = a, *y = b;
    float s = 0;
    for (int i = 0; i < *(int const*)state; ++i) s += fabsf(bf16(x[i]) - bf16(y[i]));
    return s;
}
"""


def _python_includes() -> list:
    try:
        return subprocess.run(["python3-config", "--includes"], capture_output=True, text=True,
                              check=True).stdout.split()
    except (OSError, subprocess.CalledProcessError):
        paths = sysconfig.get_paths()
        return [f"-I{paths['include']}", f"-I{paths['platinclude']}"]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both C libraries, loaded into this process, typed alike; the port's
    helper starts on the CPU."""
    before = os.environ.get("USEARCH_TORCH_DEVICE")
    os.environ["USEARCH_TORCH_DEVICE"] = "cpu"
    out = tmp_path_factory.mktemp("cabi_parity")
    libdir = sysconfig.get_config_var("LIBDIR")
    tpu_path = out / "libusearch_tpu.so"
    # c/Makefile's line, into this directory (never `make -C c`)
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", *_python_includes(), "-shared", "-o",
                    str(tpu_path), os.path.join(REPO, "c", "lib.cpp"), f"-L{libdir}", "-lpython3.12",
                    f"-Wl,-rpath,{libdir}"], check=True, capture_output=True)
    loaded = {"tpu": ctypes.CDLL(str(tpu_path)), "torch": cabi.library()}
    for name, (restype, argtypes) in cabi.SIGNATURES.items():
        fn = getattr(loaded["tpu"], name)
        fn.restype, fn.argtypes = restype, argtypes
    yield loaded
    if before is None:
        os.environ.pop("USEARCH_TORCH_DEVICE", None)
    else:
        os.environ["USEARCH_TORCH_DEVICE"] = before


@pytest.fixture(scope="module")
def udfs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cabi_udf")
    (out / "udf.c").write_text(UDF_SOURCE)
    subprocess.run(["cc", "-O2", "-fPIC", "-shared", "-o", str(out / "libudf.so"), str(out / "udf.c")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out / "libudf.so"))


def call(lib, name, *args):
    """``name(*args, &error)``; the error must stay NULL."""
    err = ctypes.c_char_p(None)
    out = getattr(lib, name)(*args, ctypes.byref(err))
    assert err.value is None, f"{name}: {err.value}"
    CALLED.add(name)
    return out


def both(libs, name, *args):
    return [call(libs[s], name, *args) for s in LIBS]


class Pair:
    """The same index in both libraries."""

    def __init__(self, libs, dtype, metric, multi, ndim):
        self.libs, self.dtype, self.ndim = libs, dtype, ndim
        self.opts = cabi.InitOptions(metric_kind=M[metric], quantization=S[dtype], dimensions=ndim,
                                     multi=multi)
        self.h = {s: call(libs[s], "usearch_init", ctypes.byref(self.opts)) for s in LIBS}
        assert all(self.h.values())

    def call(self, name, *args):
        return [call(self.libs[s], name, ctypes.c_void_p(self.h[s]), *args) for s in LIBS]

    def search(self, query, kind, k, allowed=None):
        outs = []
        for s in LIBS:
            keys, dists = np.zeros(k, np.uint64), np.zeros(k, np.float32)
            if allowed is None:
                n = call(self.libs[s], "usearch_search", ctypes.c_void_p(self.h[s]), query.ctypes.data, kind, k,
                         keys.ctypes.data_as(KEYS_P), dists.ctypes.data_as(DISTS_P))
            else:
                n = call(self.libs[s], "usearch_filtered_search", ctypes.c_void_p(self.h[s]), query.ctypes.data,
                         kind, k, allowed.ctypes.data_as(KEYS_P), len(allowed), keys.ctypes.data_as(KEYS_P),
                         dists.ctypes.data_as(DISTS_P))
            outs.append((keys[:n], dists[:n]))
        return outs

    def free(self):
        self.call("usearch_free")


def assert_same(a, b, atol=FLOAT_ATOL):
    """Keys and distances of one search: distances within the tolerance,
    keys equal apart from ties."""
    (ka, da), (kb, db) = a, b
    assert len(ka) == len(kb)
    np.testing.assert_allclose(db, da, rtol=FLOAT_RTOL, atol=atol)
    if len(ka):
        tol = atol + FLOAT_RTOL * abs(float(da[-1]))
        sure = da < da[-1] - 2 * tol  # ranks no tie can move
        assert sorted(ka[sure].tolist()) == sorted(kb[sure].tolist())


def bf16_bits(values) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def rows_for(dtype, rng, n):
    """``(rows as the C buffers hold them, their kind)``: bf16 as bits, b1
    packed, i8 added as f32 (the library casts)."""
    if dtype == "b1":
        return np.packbits(rng.random((n, BITS)) < 0.5, axis=1), S["b1"]
    x = rng.standard_normal((n, NDIM)).astype(np.float32)
    if dtype == "bf16":
        return bf16_bits(x), S["bf16"]
    return x, S["f32"]


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("dtype,metric", KINDS, ids=[f"{d}-{m}" for d, m in KINDS])
def test_index_parity(libs, dtype, metric, multi, tmp_path):
    rng = np.random.default_rng(2 * KINDS.index((dtype, metric)) + multi)
    ndim = BITS if dtype == "b1" else NDIM
    pair = Pair(libs, dtype, metric, multi, ndim)
    rows, kind = rows_for(dtype, rng, ROWS)
    keys = 1000 + (np.arange(ROWS) // 2 if multi else np.arange(ROWS))
    for key, row in zip(keys.tolist(), rows):
        pair.call("usearch_add", ctypes.c_uint64(key), row.ctypes.data, kind)
    assert pair.call("usearch_size") == [ROWS, ROWS]
    assert pair.call("usearch_dimensions") == [ndim, ndim]

    queries = np.ascontiguousarray(np.concatenate([rows[:8], rows_for(dtype, rng, 4)[0]]))
    for q in queries:
        a, b = pair.search(q, kind, K)
        assert_same(a, b)
    allowed = np.ascontiguousarray(np.unique(keys)[::3], dtype=np.uint64)
    for q in queries[:4]:
        a, b = pair.search(q, kind, K, allowed)
        assert np.isin(b[0], allowed).all()
        assert_same(a, b)

    # get: the index's own kind, f32 and bf16 (b1: packed bytes and f32)
    outs = ["b1", "f32"] if dtype == "b1" else [dtype, "f32", "bf16"]
    width = {"b1": BITS // 8}
    for out_kind in dict.fromkeys(outs):
        item = np.dtype({"f32": np.float32, "bf16": np.uint16, "i8": np.int8, "b1": np.uint8}[out_kind])
        for key in (int(keys[0]), int(keys[-1]), 99):
            bufs = [np.zeros((2, width.get(out_kind, ndim)), item) for _ in LIBS]
            got = [call(libs[s], "usearch_get", ctypes.c_void_p(pair.h[s]), ctypes.c_uint64(key), 2,
                        buf.ctypes.data, S[out_kind]) for s, buf in zip(LIBS, bufs)]
            assert got[0] == got[1] == (0 if key == 99 else 2 if multi else 1)
            assert bufs[0].tobytes() == bufs[1].tobytes()

    present, missing = ctypes.c_uint64(int(keys[5])), ctypes.c_uint64(7)
    assert pair.call("usearch_contains", present) == [True, True]
    assert pair.call("usearch_contains", missing) == [False, False]
    assert pair.call("usearch_count", present) == ([2, 2] if multi else [1, 1])

    gone = np.unique(keys)[1:40:4]
    for key in gone.tolist():
        assert pair.call("usearch_remove", ctypes.c_uint64(key)) == ([2, 2] if multi else [1, 1])
    renamed = int(np.unique(keys)[2])
    assert pair.call("usearch_rename", ctypes.c_uint64(renamed), ctypes.c_uint64(5)) == [1, 1]
    assert pair.call("usearch_contains", ctypes.c_uint64(5)) == [True, True]
    for q in queries[:6]:
        a, b = pair.search(q, kind, K)
        assert not np.isin(b[0], gone).any()
        assert_same(a, b)

    # files and buffers cross both ways
    paths = {s: str(tmp_path / f"{s}.usearch") for s in LIBS}
    for s in LIBS:
        call(libs[s], "usearch_save", ctypes.c_void_p(pair.h[s]), paths[s].encode())
    metas = []
    for s in LIBS:
        for p in paths.values():
            opts = cabi.InitOptions()
            call(libs[s], "usearch_metadata", p.encode(), ctypes.byref(opts))
            metas.append((opts.metric_kind, opts.quantization, opts.dimensions, opts.multi))
    assert set(metas) == {(M[metric], S[dtype], ndim, multi)}
    lengths = pair.call("usearch_serialized_length")
    buffers = {s: ctypes.create_string_buffer(n) for s, n in zip(LIBS, lengths)}
    for s in LIBS:
        call(libs[s], "usearch_save_buffer", ctypes.c_void_p(pair.h[s]), buffers[s], len(buffers[s]))
        for t in LIBS:
            opts = cabi.InitOptions()
            call(libs[t], "usearch_metadata_buffer", buffers[s], len(buffers[s]), ctypes.byref(opts))
            assert (opts.metric_kind, opts.quantization, opts.dimensions, opts.multi) == metas[0]
    other = {"tpu": "torch", "torch": "tpu"}
    crossed = []
    for how in ("usearch_load", "usearch_view", "usearch_load_buffer", "usearch_view_buffer"):
        loaded = Pair(libs, dtype, metric, multi, ndim)
        for s in LIBS:
            source = other[s]
            if how.endswith("buffer"):
                call(libs[s], how, ctypes.c_void_p(loaded.h[s]), buffers[source], len(buffers[source]))
            else:
                call(libs[s], how, ctypes.c_void_p(loaded.h[s]), paths[source].encode())
        assert loaded.call("usearch_size") == pair.call("usearch_size")
        crossed.append(loaded)
    for q in queries[:3]:
        want = pair.search(q, kind, K)
        for loaded in crossed:
            got = loaded.search(q, kind, K)
            for s in range(2):
                assert_same(want[s], got[s])
    for loaded in crossed:
        loaded.free()

    pair.call("usearch_clear")
    assert pair.call("usearch_size") == [0, 0]
    pair.free()


def test_index_surface(libs):
    """The calls on an index that return no search: version, capacity,
    expansions, threads, memory, hardware, the metric swap."""
    assert libs["torch"].usearch_version() == b"2.21.0+torch.0.1"
    assert b"tpu" in libs["tpu"].usearch_version()
    CALLED.add("usearch_version")
    pair = Pair(libs, "f32", "l2sq", False, NDIM)
    pair.call("usearch_reserve", 100)
    assert all(c >= 100 for c in pair.call("usearch_capacity"))
    assert pair.call("usearch_connectivity") == [16, 16]
    assert pair.call("usearch_expansion_add") == [128, 128]
    assert pair.call("usearch_expansion_search") == [64, 64]
    pair.call("usearch_change_expansion_add", 200)
    pair.call("usearch_change_expansion_search", 96)
    assert pair.call("usearch_expansion_add") == [200, 200]
    assert pair.call("usearch_expansion_search") == [96, 96]
    pair.call("usearch_change_threads_add", 4)
    pair.call("usearch_change_threads_search", 4)
    assert pair.call("usearch_hardware_acceleration")[1] == b"cpu"
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, NDIM)).astype(np.float32)
    for i, row in enumerate(x):
        pair.call("usearch_add", ctypes.c_uint64(i), row.ctypes.data, S["f32"])
    assert all(m > 0 for m in pair.call("usearch_memory_usage"))
    for metric in ("cos", "ip", "l2sq"):
        pair.call("usearch_change_metric_kind", M[metric])
        for q in x[:4]:
            a, b = pair.search(q, S["f32"], K)
            assert_same(a, b)
    pair.free()


@pytest.mark.parametrize("dtype,metrics", [("f32", ("cos", "ip", "l2sq")), ("i8", ("ip", "cos", "l2sq")),
                                           ("bf16", ("l2sq", "cos")), ("b1", ("hamming", "tanimoto"))])
def test_distance(libs, dtype, metrics):
    rng = np.random.default_rng(5)
    rows, kind = rows_for(dtype, rng, 6)
    if dtype == "i8":
        rows, kind = np.clip(np.round(rows * 40), -127, 127).astype(np.int8), S["i8"]
    ndim = BITS if dtype == "b1" else NDIM
    for metric in metrics:
        for a, b in zip(rows[:3], rows[3:]):
            got = both(libs, "usearch_distance", a.ctypes.data, b.ctypes.data, kind, ndim, M[metric])
            atol = I8_COS_ATOL if (dtype, metric) == ("i8", "cos") else FLOAT_ATOL
            np.testing.assert_allclose(got[1], got[0], rtol=FLOAT_RTOL, atol=atol)


@pytest.mark.parametrize("dtype,metric", [("f32", "l2sq"), ("bf16", "cos"), ("i8", "ip"), ("b1", "hamming")])
def test_strided_exact_search(libs, dtype, metric):
    """Rows and queries inside wider rows, results into wider rows."""
    rng = np.random.default_rng(11)
    n, nq, k = 200, 12, 7
    data, kind = rows_for(dtype, rng, n + nq)
    if dtype == "i8":
        data, kind = np.clip(np.round(data * 40), -127, 127).astype(np.int8), S["i8"]
    ndim = BITS if dtype == "b1" else NDIM
    per = data.shape[1]
    ds = np.zeros((n, per + 5), data.dtype)
    ds[:, :per] = data[:n]
    qs = np.zeros((nq, per + 3), data.dtype)
    qs[:, :per] = data[n:]
    outs = []
    for s in LIBS:
        keys, dists = np.zeros((nq, k + 2), np.uint64), np.zeros((nq, k + 3), np.float32)
        call(libs[s], "usearch_exact_search", ds.ctypes.data, n, ds.strides[0], qs.ctypes.data, nq, qs.strides[0],
             kind, ndim, M[metric], k, 0, keys.ctypes.data_as(KEYS_P), keys.strides[0],
             dists.ctypes.data_as(DISTS_P), dists.strides[0])
        outs.append((keys[:, :k], dists[:, :k]))
    for i in range(nq):
        assert_same((outs[0][0][i], outs[0][1][i]), (outs[1][0][i], outs[1][1][i]))


@pytest.mark.parametrize("dtype,fn,multi", [("f32", "l1_f32", False), ("f32", "l1_f32_state", False),
                                            ("f32", "l1_f32", True), ("bf16", "l1_bf16_state", False)])
def test_pointer_metric(libs, udfs, dtype, fn, multi):
    """A C function pointer as the metric (stateful when it takes a third
    argument): the host loop per pair in both libraries; the bf16 index's
    rows reach it as their stored bits, f32 queries cast to bf16 first."""
    rng = np.random.default_rng(13)
    pair = Pair(libs, dtype, "l2sq", multi, NDIM)
    rows, kind = rows_for(dtype, rng, 64)
    keys = np.arange(64) // 2 if multi else np.arange(64)
    for key, row in zip(keys.tolist(), rows):
        pair.call("usearch_add", ctypes.c_uint64(key), row.ctypes.data, kind)
    state = ctypes.c_int(NDIM)
    pointer = ctypes.cast(getattr(udfs, fn), ctypes.c_void_p)
    state_ptr = ctypes.cast(ctypes.pointer(state), ctypes.c_void_p) if fn.endswith("state") else None
    pair.call("usearch_change_metric", pointer, state_ptr, M["unknown"])
    queries = rng.standard_normal((4, NDIM)).astype(np.float32)  # f32 queries, whatever the index
    for q in list(queries) + ([] if dtype == "bf16" else list(rows[:4])):
        a, b = pair.search(q, S["f32"], K)
        np.testing.assert_array_equal(a[1], b[1])  # one C function on the same operands
        assert_same(a, b, atol=0.0)
    allowed = np.ascontiguousarray(np.unique(keys)[::5], dtype=np.uint64)
    a, b = pair.search(queries[0], S["f32"], K, allowed)
    np.testing.assert_array_equal(a[1], b[1])
    assert np.isin(b[0], allowed).all()
    pair.free()


def test_every_header_function_called():
    """Runs last: every function usearch_torch.h declares was called."""
    text = re.sub(r"/\*.*?\*/", "", cabi.HEADER.read_text(), flags=re.S)
    declared = {name for name in re.findall(r"\b(usearch_\w+)\s*\(", text) if not name.endswith("_t")}
    assert declared == set(cabi.SIGNATURES)
    assert not declared - CALLED, f"uncalled: {sorted(declared - CALLED)}"
