// usearch_torch C ABI implementation.
//
// The C interface of c/usearch_tpu.h (the reference's c/lib.cpp over
// index_dense_t) over the PyTorch/CUDA engine: the library embeds CPython,
// and a single process-wide interpreter hosts `usearch_torch` and the CUDA
// runtime; each usearch_index_t handle maps to a Python `Index` in a
// registry. Buffers cross the boundary as raw pointers, wrapped zero-copy on
// the Python side with ctypes and numpy; results are memmoved back into the
// caller's buffers. bf16 crosses as its uint16 bits (numpy has no bfloat16).
//
// Indexes and searches run on the card unless USEARCH_TORCH_DEVICE=cpu
// (read once, when the helper starts); without a card they fail, never
// falling back to the CPU.
//
// Build: `python3 -c "import usearch_torch.cabi as c; print(c.build())"`
// (g++, linked to libpython3.12; see __init__.py).

#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <mutex>

#include "usearch_torch.h"

namespace {

thread_local char tls_error[1024];

char const* kHelperModule = "__usearch_torch_cabi__";

char const* kHelperSource = R"PY(
import ctypes
import os
import sys

if not getattr(sys, "argv", None):  # an embedded interpreter may have none
    sys.argv = ["usearch_torch"]

import numpy as np
import torch

from usearch_torch import Index, MetricKind
from usearch_torch.enums import ScalarKind, normalize_dtype
from usearch_torch.exact import exact_search
from usearch_torch.ops.casts import cast_vectors

#: the device of every index and search: the card unless the caller asks
#: for the CPU; an absent card raises where an index or a search starts
_DEVICE = os.environ.get("USEARCH_TORCH_DEVICE", "cuda").strip().lower() or "cuda"
if _DEVICE not in ("cuda", "cpu"):
    raise ValueError(f"USEARCH_TORCH_DEVICE must be 'cpu' or 'cuda', not {_DEVICE!r}")

_indexes = {}
_next_handle = [1]

_METRICS = {1: "cos", 2: "ip", 3: "l2sq", 4: "haversine", 5: "divergence",
            6: "pearson", 7: "jaccard", 8: "hamming", 9: "tanimoto", 10: "sorensen"}
_METRIC_IDS = {v: k for k, v in _METRICS.items()}
_SCALARS = {1: "f32", 2: "f64", 3: "f16", 4: "bf16", 5: "i8", 6: "b1"}
_SCALAR_IDS = {v: k for k, v in _SCALARS.items()}
_BF16 = 4
#: numpy's dtype of each kind's C buffer; bf16 is its uint16 bits
_NP_DTYPES = {1: np.float32, 2: np.float64, 3: np.float16, 4: np.uint16, 5: np.int8, 6: np.uint8}


def _wrap(ptr, count, kind_id):
    """``count`` elements of a C buffer, zero-copy (bf16 as uint16 bits)."""
    dt = np.dtype(_NP_DTYPES[kind_id])
    buf = (ctypes.c_char * (count * dt.itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=dt, count=count)


def _bf16_to_f32(bits):
    """bf16 bits as f32 values, exactly (every bf16 is an f32)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(values):
    """f32 values rounded to bf16 (to nearest even), as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _engine_rows(rows, kind_id):
    """A C batch as the engine takes it, with the kind to store it as (None:
    the index's): bf16 bits become their f32 values, which the engine's
    casts treat as the bf16 input they are (bf16 -> f32 is exact)."""
    if kind_id == _BF16:
        return _bf16_to_f32(rows), "bf16"
    return rows, None


def _row_elems(index, kind_id):
    if kind_id == 6:  # b1 packed bytes
        return (index.ndim + 7) // 8
    return index.ndim


def init(metric_id, quant_id, dims, conn, ea, es, multi, metric_ptr=0):
    index = Index(
        ndim=dims,
        metric=_METRICS.get(metric_id, "cos"),
        dtype=_SCALARS.get(quant_id),
        connectivity=conn or 16,
        expansion_add=ea or 128,
        expansion_search=es or 64,
        multi=bool(multi),
        device=_DEVICE,
    )
    h = _next_handle[0]
    _next_handle[0] += 1
    _indexes[h] = index
    if metric_ptr and metric_id == 0:  # unknown kind + pointer = custom metric
        change_metric(h, metric_ptr, 0, 0)
    return h


def free(h):
    _indexes.pop(h, None)
    _host_metrics.pop(h, None)
    _threads.pop((h, 0), None)
    _threads.pop((h, 1), None)
    return 0


def _ix(h):
    return _indexes[h]


def size(h): return len(_ix(h))
def capacity(h): return _ix(h).capacity
def dimensions(h): return _ix(h).ndim
def connectivity(h): return _ix(h).connectivity
def memory_usage(h): return _ix(h).memory_usage
def serialized_length(h): return _ix(h).serialized_length
def expansion_add(h): return _ix(h).expansion_add
def expansion_search(h): return _ix(h).expansion_search
def hardware(h): return _ix(h).hardware_acceleration
def reserve(h, cap): _ix(h).reserve(cap); return 0
def clear(h): _ix(h).clear(); return 0
def save(h, path): _ix(h).save(path); return 0
def load(h, path): _ix(h).load(path); return 0
def view(h, path): _ix(h).view(path); return 0
def contains(h, key): return 1 if _ix(h).contains(key) else 0
def count(h, key): return int(_ix(h).count(key))
def remove(h, key): return int(_ix(h).remove(key))
def rename(h, src, dst): return 1 if _ix(h).rename(src, dst) else 0
def change_expansion_add(h, v): _ix(h).expansion_add = v; return 0
def change_expansion_search(h, v): _ix(h).expansion_search = v; return 0


def _meta_tuple(meta):
    if meta is None:
        raise ValueError("not a usearch index file")
    return (
        _METRIC_IDS.get(meta["kind_metric"], 0),
        _SCALAR_IDS.get(meta["kind_scalar"], 0),
        int(meta["dimensions"]),
        1 if meta.get("multi") else 0,
    )


def metadata(path):
    return _meta_tuple(Index.metadata(path))


def metadata_buffer(ptr, length):
    return _meta_tuple(Index.metadata(ctypes.string_at(ptr, length)))


def save_buffer(h, out_ptr, length):
    from usearch_torch.persist import save_index_to_buffer

    data = save_index_to_buffer(_ix(h))
    if len(data) > length:
        raise ValueError(f"buffer too small: need {len(data)}, got {length}")
    ctypes.memmove(out_ptr, data, len(data))
    return len(data)


def load_buffer(h, ptr, length):
    _ix(h).load(ctypes.string_at(ptr, length))
    return 0


def view_buffer(h, ptr, length):
    _ix(h).view(ctypes.string_at(ptr, length))
    return 0


_threads = {}


def change_threads(h, which, n):
    # the card schedules device parallelism; recorded for API compatibility only
    _threads[(h, which)] = int(n)
    return 0


_host_metrics = {}


def change_metric_kind(h, kind_id):
    _host_metrics.pop(h, None)
    _ix(h).metric = _METRICS[kind_id]
    return 0


def change_metric(h, fn_ptr, state_ptr, kind_id):
    """C-pointer UDF: searches run host-side per pair, the reference's own
    CPU UDF cost model (it too calls the pointer per candidate)."""
    if state_ptr:
        cf = ctypes.CFUNCTYPE(
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p
        )(fn_ptr)
        f = lambda a, b: cf(a, b, state_ptr)
    else:
        f = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p)(fn_ptr)
    _host_metrics[h] = f
    if kind_id:
        _ix(h)._metric_kind = MetricKind(_METRICS[kind_id])  # serialization tag
    return 0


def _stored_host_rows(index, slots):
    """The rows at ``slots`` in the index's stored representation, on the
    host (a bf16 index's as their bits, which numpy holds as uint16)."""
    if index.dtype == ScalarKind.BF16:
        rows = index._stored_rows(slots)[:, : index.ndim]
        return rows.view(torch.int16).cpu().numpy().view(np.uint16)
    return index._fetch_slots(slots, index.dtype)


def _host_search(index, f, q, k, keys_ptr, dists_ptr, allowed, q_kind_id):
    # slot-aligned fetch: keys may repeat under `multi`, and get() would
    # return ragged per-key matrices; walking live SLOTS keeps rows[i]
    # aligned with keys[i] in every mode
    slots = index._live_slots()
    keys = index._slot_keys[slots].astype(np.uint64)
    if allowed is not None:
        m = np.isin(keys, allowed)
        keys, slots = keys[m], slots[m]
    if keys.size == 0:
        return 0
    rows = np.atleast_2d(np.ascontiguousarray(_stored_host_rows(index, slots)))
    # the UDF sees BOTH operands in the index's stored representation: cast
    # the query from the caller's kind first (the reference casts via
    # cast_buffer_ before invoking punned UDFs)
    q_kind = normalize_dtype(_SCALARS.get(q_kind_id, "f32"))
    if q_kind != index.dtype:
        src, src_kind = q, q_kind
        if q_kind == ScalarKind.BF16:
            src, src_kind = _bf16_to_f32(q), ScalarKind.F32
        cast = cast_vectors(np.atleast_2d(src), src_kind, index.dtype, index.ndim)[0]
        q = cast.view(torch.int16).numpy().view(np.uint16) if index.dtype == ScalarKind.BF16 else cast.numpy()
    q = np.ascontiguousarray(q)
    dists = np.empty(rows.shape[0], np.float32)
    qp = q.ctypes.data
    base = rows.ctypes.data
    step = rows.strides[0]
    for i in range(rows.shape[0]):
        dists[i] = f(qp, base + i * step)
    k = min(k, len(dists))
    sel = np.argpartition(dists, k - 1)[:k]
    sel = sel[np.argsort(dists[sel], kind="stable")]
    out_k = np.ascontiguousarray(keys[sel])
    out_d = np.ascontiguousarray(dists[sel], dtype=np.float32)
    ctypes.memmove(keys_ptr, out_k.ctypes.data, out_k.nbytes)
    ctypes.memmove(dists_ptr, out_d.ctypes.data, out_d.nbytes)
    return int(k)


def add(h, key, vec_ptr, kind_id):
    index = _ix(h)
    row = _wrap(vec_ptr, _row_elems(index, kind_id), kind_id).copy()
    index.add(key, _engine_rows(row, kind_id)[0])
    return 0


def search(h, query_ptr, kind_id, k, keys_ptr, dists_ptr, allowed_ptr, allowed_n):
    index = _ix(h)
    q = _wrap(query_ptr, _row_elems(index, kind_id), kind_id).copy()
    allowed = None
    if allowed_ptr:
        allowed = _wrap(allowed_ptr, allowed_n, 2).view(np.uint64).copy()
    if h in _host_metrics:
        return _host_search(index, _host_metrics[h], q, k, keys_ptr, dists_ptr, allowed, kind_id)
    kwargs = {} if allowed is None else {"filter": allowed}
    m = index.search(_engine_rows(q, kind_id)[0], k, **kwargs)
    n = len(m.keys)
    if n:
        keys = np.ascontiguousarray(m.keys, dtype=np.uint64)
        dists = np.ascontiguousarray(m.distances, dtype=np.float32)
        ctypes.memmove(keys_ptr, keys.ctypes.data, keys.nbytes)
        ctypes.memmove(dists_ptr, dists.ctypes.data, dists.nbytes)
    return int(n)


def get(h, key, max_count, out_ptr, kind_id):
    index = _ix(h)
    # the port's `get` gives no bf16 (numpy has none): decode to f32, then
    # round to bf16 bits, as the JAX package rounds its f32 decoding
    got = index.get(key, "f32" if kind_id == _BF16 else _SCALARS.get(kind_id))
    if got is None:
        return 0
    if kind_id == _BF16:
        got = _f32_to_bf16(got)
    rows = np.atleast_2d(np.asarray(got, dtype=_NP_DTYPES[kind_id]))[:max_count]
    rows = np.ascontiguousarray(rows)
    ctypes.memmove(out_ptr, rows.ctypes.data, rows.nbytes)
    return int(rows.shape[0])


def distance(a_ptr, b_ptr, kind_id, dims, metric_id):
    n = ((dims + 7) // 8) if kind_id == 6 else dims
    a, dtype = _engine_rows(_wrap(a_ptr, n, kind_id)[None, :], kind_id)
    b, _ = _engine_rows(_wrap(b_ptr, n, kind_id)[None, :], kind_id)
    m = exact_search(b, a, 1, metric=_METRICS.get(metric_id, "cos"), dtype=dtype, device=_DEVICE)
    return float(m.distances[0, 0])


def _strided_rows(ptr, n, stride, kind_id, per):
    """Rows from a C buffer honoring a BYTE stride (0 = tight)."""
    dt = np.dtype(_NP_DTYPES[kind_id])
    row_bytes = per * dt.itemsize
    if n == 0:
        return np.zeros((0, per), dt)
    if not stride or stride == row_bytes:
        return _wrap(ptr, n * per, kind_id).reshape(n, per)
    total = (n - 1) * stride + row_bytes  # never read past the last row
    buf = np.frombuffer((ctypes.c_char * total).from_address(ptr), np.uint8)
    sv = np.lib.stride_tricks.as_strided(buf, shape=(n, row_bytes), strides=(stride, 1))
    return np.ascontiguousarray(sv).view(dt).reshape(n, per)


def exact(ds_ptr, ds_n, ds_stride, q_ptr, q_n, q_stride, kind_id, dims,
          metric_id, k, keys_ptr, keys_stride, dists_ptr, dists_stride):
    per = ((dims + 7) // 8) if kind_id == 6 else dims
    ds, dtype = _engine_rows(_strided_rows(ds_ptr, ds_n, ds_stride, kind_id, per), kind_id)
    qs, _ = _engine_rows(_strided_rows(q_ptr, q_n, q_stride, kind_id, per), kind_id)
    m = exact_search(ds, qs, k, metric=_METRICS.get(metric_id, "cos"), dtype=dtype, device=_DEVICE)
    keys = np.ascontiguousarray(m.keys, dtype=np.uint64)
    dists = np.ascontiguousarray(m.distances, dtype=np.float32)
    kk = int(keys.shape[1])
    krow, drow = kk * 8, kk * 4
    ks = keys_stride or krow
    dstr = dists_stride or drow
    if ks == krow and dstr == drow:
        ctypes.memmove(keys_ptr, keys.ctypes.data, keys.nbytes)
        ctypes.memmove(dists_ptr, dists.ctypes.data, dists.nbytes)
    else:  # strided outputs: one memmove per row
        for i in range(q_n):
            ctypes.memmove(keys_ptr + i * ks, keys[i].ctypes.data, krow)
            ctypes.memmove(dists_ptr + i * dstr, dists[i].ctypes.data, drow)
    return kk
)PY";

PyObject* g_helper = nullptr;
std::mutex g_init_mutex;

void capture_error(usearch_error_t* error);

bool ensure_python(usearch_error_t* error) {
    std::lock_guard<std::mutex> lock(g_init_mutex);
    if (g_helper)
        return true;
    // When the library starts the interpreter itself, the first calling
    // thread keeps the GIL (Py_InitializeEx takes it, and the gilstate pairs
    // below never drop a state that was already held), so every later call
    // must come from that same thread. Inside a Python process (ctypes) the
    // interpreter is the host's, and any thread may call.
    if (!Py_IsInitialized())
        Py_InitializeEx(0);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* module = PyImport_AddModule(kHelperModule);  // borrowed
    PyObject* result = nullptr;
    if (module) {
        PyObject* globals = PyModule_GetDict(module);
        if (PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins()) == 0)
            result = PyRun_String(kHelperSource, Py_file_input, globals, globals);
    }
    if (!result) {
        // the cause (no torch, no usearch_torch on PYTHONPATH, a bad
        // USEARCH_TORCH_DEVICE) goes into the error
        capture_error(error);
        PyGILState_Release(gil);
        return false;
    }
    Py_DECREF(result);
    g_helper = module;
    Py_INCREF(g_helper);
    PyGILState_Release(gil);
    return true;
}

void capture_error(usearch_error_t* error) {
    if (!PyErr_Occurred())
        return;
    PyObject *type, *value, *trace;
    PyErr_Fetch(&type, &value, &trace);
    PyObject* str = value ? PyObject_Str(value) : nullptr;
    char const* msg = str ? PyUnicode_AsUTF8(str) : "unknown python error";
    std::snprintf(tls_error, sizeof(tls_error), "%s", msg ? msg : "unknown python error");
    Py_XDECREF(str);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(trace);
    PyErr_Clear();
    if (error)
        *error = tls_error;
}

// Holds the GIL for a scope (ctypes drops it around a foreign call).
struct gil_t {
    PyGILState_STATE state = PyGILState_Ensure();
    ~gil_t() { PyGILState_Release(state); }
};

// helper.<fn>(args...) with a "K..."-style format; returns a new reference,
// or null with the error captured. The caller holds the GIL.
PyObject* call(usearch_error_t* error, char const* fn, char const* fmt, ...) {
    PyObject* callable = PyObject_GetAttrString(g_helper, fn);
    PyObject* result = nullptr;
    if (callable) {
        va_list args;
        va_start(args, fmt);
        PyObject* tuple = Py_VaBuildValue(fmt, args);
        va_end(args);
        if (tuple) {
            result = PyObject_CallObject(callable, tuple);
            Py_DECREF(tuple);
        }
        Py_DECREF(callable);
    }
    if (!result)
        capture_error(error);
    return result;
}

// The result of a helper call as an unsigned integer (0 on error).
template <typename... args_at>
uint64_t call_u64(usearch_error_t* error, char const* fn, char const* fmt, args_at... args) {
    if (!ensure_python(error))
        return 0;
    gil_t gil;
    PyObject* result = call(error, fn, fmt, args...);
    if (!result)
        return 0;
    uint64_t out = PyLong_AsUnsignedLongLong(result);
    if (PyErr_Occurred()) {
        PyErr_Clear();
        out = 0;
    }
    Py_DECREF(result);
    return out;
}

// Reads the (metric, scalar, dims, multi) tuple of a helper call into
// `options` (NULL: validation only).
template <typename... args_at>
void call_metadata(usearch_init_options_t* options, usearch_error_t* error, char const* fn,
                   char const* fmt, args_at... args) {
    if (!ensure_python(error))
        return;
    gil_t gil;
    PyObject* r = call(error, fn, fmt, args...);
    if (r && options) {
        unsigned long long metric = 0, scalar = 0, dims = 0, multi = 0;
        if (PyArg_ParseTuple(r, "KKKK", &metric, &scalar, &dims, &multi)) {
            options->metric_kind = (usearch_metric_kind_t)metric;
            options->quantization = (usearch_scalar_kind_t)scalar;
            options->dimensions = (size_t)dims;
            options->multi = multi != 0;
        } else {
            capture_error(error);
        }
    }
    Py_XDECREF(r);
}

}  // namespace

// Built with -fvisibility=hidden: the usearch_* functions alone are exported.
#pragma GCC visibility push(default)
extern "C" {

char const* usearch_version(void) { return "2.21.0+torch.0.1"; }

usearch_index_t usearch_init(usearch_init_options_t* options, usearch_error_t* error) {
    if (error)
        *error = nullptr;
    uint64_t handle = call_u64(
        error, "init", "(KKKKKKKK)", (unsigned long long)(options ? options->metric_kind : 1),
        (unsigned long long)(options ? options->quantization : 0),
        (unsigned long long)(options ? options->dimensions : 0),
        (unsigned long long)(options ? options->connectivity : 0),
        (unsigned long long)(options ? options->expansion_add : 0),
        (unsigned long long)(options ? options->expansion_search : 0),
        (unsigned long long)(options && options->multi ? 1 : 0),
        (unsigned long long)(options ? (uintptr_t)options->metric : 0));
    return (usearch_index_t)(uintptr_t)handle;
}

#define HANDLE (unsigned long long)(uintptr_t)index

void usearch_free(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "free", "(K)", HANDLE);
}

size_t usearch_memory_usage(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "memory_usage", "(K)", HANDLE);
}

char const* usearch_hardware_acceleration(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    static thread_local char hw[64];
    if (!ensure_python(error))
        return "unknown";
    gil_t gil;
    PyObject* r = call(error, "hardware", "(K)", HANDLE);
    char const* s = r ? PyUnicode_AsUTF8(r) : nullptr;
    std::snprintf(hw, sizeof(hw), "%s", s ? s : "unknown");
    Py_XDECREF(r);
    return hw;
}

size_t usearch_serialized_length(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "serialized_length", "(K)", HANDLE);
}

void usearch_save(usearch_index_t index, char const* path, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "save", "(Ks)", HANDLE, path);
}

void usearch_load(usearch_index_t index, char const* path, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "load", "(Ks)", HANDLE, path);
}

void usearch_view(usearch_index_t index, char const* path, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "view", "(Ks)", HANDLE, path);
}

void usearch_metadata(char const* path, usearch_init_options_t* options, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_metadata(options, error, "metadata", "(s)", path);
}

size_t usearch_size(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "size", "(K)", HANDLE);
}

size_t usearch_capacity(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "capacity", "(K)", HANDLE);
}

size_t usearch_dimensions(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "dimensions", "(K)", HANDLE);
}

size_t usearch_connectivity(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "connectivity", "(K)", HANDLE);
}

void usearch_reserve(usearch_index_t index, size_t capacity, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "reserve", "(KK)", HANDLE, (unsigned long long)capacity);
}

size_t usearch_expansion_add(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "expansion_add", "(K)", HANDLE);
}

size_t usearch_expansion_search(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "expansion_search", "(K)", HANDLE);
}

void usearch_change_expansion_add(usearch_index_t index, size_t expansion, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "change_expansion_add", "(KK)", HANDLE, (unsigned long long)expansion);
}

void usearch_change_expansion_search(usearch_index_t index, size_t expansion,
                                     usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "change_expansion_search", "(KK)", HANDLE, (unsigned long long)expansion);
}

void usearch_add(usearch_index_t index, usearch_key_t key, void const* vector,
                 usearch_scalar_kind_t vector_kind, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "add", "(KKKK)", HANDLE, (unsigned long long)key,
             (unsigned long long)(uintptr_t)vector, (unsigned long long)vector_kind);
}

bool usearch_contains(usearch_index_t index, usearch_key_t key, usearch_error_t* error) {
    if (error) *error = nullptr;
    return call_u64(error, "contains", "(KK)", HANDLE, (unsigned long long)key) != 0;
}

size_t usearch_count(usearch_index_t index, usearch_key_t key, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "count", "(KK)", HANDLE, (unsigned long long)key);
}

size_t usearch_search(usearch_index_t index, void const* query, usearch_scalar_kind_t query_kind,
                      size_t count, usearch_key_t* found_keys,
                      usearch_distance_t* found_distances, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "search", "(KKKKKKKK)", HANDLE,
                            (unsigned long long)(uintptr_t)query, (unsigned long long)query_kind,
                            (unsigned long long)count, (unsigned long long)(uintptr_t)found_keys,
                            (unsigned long long)(uintptr_t)found_distances, 0ULL, 0ULL);
}

size_t usearch_filtered_search(usearch_index_t index, void const* query,
                               usearch_scalar_kind_t query_kind, size_t count,
                               usearch_key_t const* allowed_keys, size_t allowed_count,
                               usearch_key_t* found_keys, usearch_distance_t* found_distances,
                               usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "search", "(KKKKKKKK)", HANDLE,
                            (unsigned long long)(uintptr_t)query, (unsigned long long)query_kind,
                            (unsigned long long)count, (unsigned long long)(uintptr_t)found_keys,
                            (unsigned long long)(uintptr_t)found_distances,
                            (unsigned long long)(uintptr_t)allowed_keys,
                            (unsigned long long)allowed_count);
}

size_t usearch_get(usearch_index_t index, usearch_key_t key, size_t count, void* vectors,
                   usearch_scalar_kind_t vector_kind, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "get", "(KKKKK)", HANDLE, (unsigned long long)key,
                            (unsigned long long)count, (unsigned long long)(uintptr_t)vectors,
                            (unsigned long long)vector_kind);
}

size_t usearch_remove(usearch_index_t index, usearch_key_t key, usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "remove", "(KK)", HANDLE, (unsigned long long)key);
}

size_t usearch_rename(usearch_index_t index, usearch_key_t from, usearch_key_t to,
                      usearch_error_t* error) {
    if (error) *error = nullptr;
    return (size_t)call_u64(error, "rename", "(KKK)", HANDLE, (unsigned long long)from,
                            (unsigned long long)to);
}

usearch_distance_t usearch_distance(void const* vector_first, void const* vector_second,
                                    usearch_scalar_kind_t kind, size_t dimensions,
                                    usearch_metric_kind_t metric_kind, usearch_error_t* error) {
    if (error) *error = nullptr;
    if (!ensure_python(error))
        return 0.0f;
    gil_t gil;
    PyObject* r = call(error, "distance", "(KKKKK)", (unsigned long long)(uintptr_t)vector_first,
                       (unsigned long long)(uintptr_t)vector_second, (unsigned long long)kind,
                       (unsigned long long)dimensions, (unsigned long long)metric_kind);
    if (!r)
        return 0.0f;
    double out = PyFloat_AsDouble(r);
    Py_DECREF(r);
    return (usearch_distance_t)out;
}

void usearch_exact_search(void const* dataset, size_t dataset_count, size_t dataset_stride,
                          void const* queries, size_t queries_count, size_t queries_stride,
                          usearch_scalar_kind_t scalar_kind, size_t dimensions,
                          usearch_metric_kind_t metric_kind, size_t count, size_t threads,
                          usearch_key_t* keys, size_t keys_stride,
                          usearch_distance_t* distances, size_t distances_stride,
                          usearch_error_t* error) {
    (void)threads;
    if (error) *error = nullptr;
    call_u64(error, "exact", "(KKKKKKKKKKKKKK)", (unsigned long long)(uintptr_t)dataset,
             (unsigned long long)dataset_count, (unsigned long long)dataset_stride,
             (unsigned long long)(uintptr_t)queries, (unsigned long long)queries_count,
             (unsigned long long)queries_stride, (unsigned long long)scalar_kind,
             (unsigned long long)dimensions, (unsigned long long)metric_kind,
             (unsigned long long)count, (unsigned long long)(uintptr_t)keys,
             (unsigned long long)keys_stride, (unsigned long long)(uintptr_t)distances,
             (unsigned long long)distances_stride);
}

void usearch_clear(usearch_index_t index, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "clear", "(K)", HANDLE);
}

void usearch_save_buffer(usearch_index_t index, void* buffer, size_t length,
                         usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "save_buffer", "(KKK)", HANDLE, (unsigned long long)(uintptr_t)buffer,
             (unsigned long long)length);
}

void usearch_load_buffer(usearch_index_t index, void const* buffer, size_t length,
                         usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "load_buffer", "(KKK)", HANDLE, (unsigned long long)(uintptr_t)buffer,
             (unsigned long long)length);
}

void usearch_view_buffer(usearch_index_t index, void const* buffer, size_t length,
                         usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "view_buffer", "(KKK)", HANDLE, (unsigned long long)(uintptr_t)buffer,
             (unsigned long long)length);
}

void usearch_metadata_buffer(void const* buffer, size_t length, usearch_init_options_t* options,
                             usearch_error_t* error) {
    if (error) *error = nullptr;
    call_metadata(options, error, "metadata_buffer", "(KK)",
                  (unsigned long long)(uintptr_t)buffer, (unsigned long long)length);
}

void usearch_change_threads_add(usearch_index_t index, size_t threads, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "change_threads", "(KKK)", HANDLE, 0ULL, (unsigned long long)threads);
}

void usearch_change_threads_search(usearch_index_t index, size_t threads,
                                   usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "change_threads", "(KKK)", HANDLE, 1ULL, (unsigned long long)threads);
}

void usearch_change_metric_kind(usearch_index_t index, usearch_metric_kind_t kind,
                                usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "change_metric_kind", "(KK)", HANDLE, (unsigned long long)kind);
}

void usearch_change_metric(usearch_index_t index, usearch_metric_t metric, void* state,
                           usearch_metric_kind_t kind, usearch_error_t* error) {
    if (error) *error = nullptr;
    call_u64(error, "change_metric", "(KKKK)", HANDLE, (unsigned long long)(uintptr_t)metric,
             (unsigned long long)(uintptr_t)state, (unsigned long long)kind);
}

}  // extern "C"
#pragma GCC visibility pop
