"""Persistence: save, load, view and metadata, in the JAX package's file
format, and import and export of the upstream `.usearch` format.

Counterpart of `usearch_tpu/persist.py`, byte for byte in its format, so a
file written by either package loads in the other. A view loads the rows
onto the device whole, or, streamed (``view(stream=True)``, or a table
above `STREAM_SHARE` of the device's memory), keeps them in the file's
memory map and searches them in tiles streamed through the device
(stream.py).

Format v2 (little-endian):
    [0:12)   magic  b"usearch_tpu\\0"
    [12:14)  u16    format version
    [14:16)  u16    reserved
    [16:20)  u32    JSON header length H
    [20:20+H) JSON  {metric, dtype, ndim, count, multi, row_bytes, set_index,
                     library_version, connectivity, expansion_add,
                     expansion_search[, ivf]}
    then     count x u64 keys
    then     count x row_bytes rows (the stored representation, unpadded)
    then     (with "ivf" in the header) the dense IVF of
             `optimize(reorder=True)`: n_chunks x centroid_width f32
             centroids, n_chunks i32 starts, n_chunks i32 lens, n_fresh i32
             fresh slots, so a loaded index serves its partitions at once.

Only live rows are written, in slot order: removals compact the file, and
the IVF's starts, lens and fresh slots are remapped to the compacted
positions. Spill shadows are not live, so a spilled index loads without
them, in both packages.
"""

from __future__ import annotations

import json
import os
import struct
import threading

import numpy as np
import torch

from .enums import ScalarKind, normalize_dtype
from .ivf import DENSE_BLOCK, IVFPartitions
from .ops.distances import row_stats

MAGIC = b"usearch_tpu\x00"
FORMAT_VERSION = 2
LIBRARY_VERSION = "2.21.0+torch.0.1"
#: rows gathered on the device (save) or uploaded to it (load) per step
ROW_CHUNK = 1 << 20
#: a view with ``stream=None`` streams its rows when they take more than
#: this share of the device's memory
STREAM_SHARE = 0.6
#: the rows' numpy dtype in a file, by storage kind: bf16 as its bits
_FILE_DTYPES = {
    ScalarKind.F64: np.float64,
    ScalarKind.F32: np.float32,
    ScalarKind.F16: np.float16,
    ScalarKind.BF16: np.int16,
    ScalarKind.I8: np.int8,
    ScalarKind.B1: np.uint8,
}


def _file_layout(kind: ScalarKind, ndim: int, set_index: bool = False):
    """(columns, numpy dtype) of one row in a file: packed bytes for b1,
    int32 entries for a set index."""
    if set_index:
        return ndim, np.int32
    return ((ndim + 7) // 8 if kind == ScalarKind.B1 else ndim), _FILE_DTYPES[kind]


def _logical_rows_np(index) -> np.ndarray:
    """The live rows in slot order, unpadded, in the stored dtype. They are
    gathered on the device in chunks and sliced to the logical columns
    there, so the host never holds the padded ``[capacity, width]`` table.
    A streamed view's rows are its file's, as they are; an f64 index's are
    its exact host copy."""
    if index._streamed:
        return index._stream_rows
    live = index._live_slots()
    if index._host_f64 is not None:
        return index._host_f64[live]
    cols, dt = _file_layout(index._dtype, index._ndim, index._is_set_index)
    out = np.empty((len(live), cols), dtype=dt)
    for off in range(0, len(live), ROW_CHUNK):
        idx = torch.as_tensor(live[off : off + ROW_CHUNK], device=index._device)
        rows = index._table[idx, :cols]
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)
        out[off : off + len(idx)] = rows.cpu().numpy()
    return out


def _header_dict(index, count: int) -> dict:
    return {
        "metric": index._metric_kind.value,
        "dtype": index._dtype.value,
        "ndim": index._ndim,
        "count": count,
        "multi": index._multi,
        "row_bytes": index._logical_row_bytes(),
        "set_index": index._is_set_index,
        "library_version": LIBRARY_VERSION,
        "connectivity": index._connectivity,
        "expansion_add": index._expansion_add,
        "expansion_search": index._expansion_search,
    }


def _saved_ivf(index):
    """The IVF a save writes: the dense one, clean; else None (the copied
    layout is cheap to rebuild)."""
    ivf = index._ivf
    if ivf is None or index._ivf_dirty or ivf.inplace_shape is None or ivf.starts is None:
        return None
    return ivf


def _ivf_head(index, ivf) -> dict:
    n_fresh = int(ivf.fresh_np.size)
    return {
        "n_chunks": int(ivf.starts.shape[0]),
        "p_win": int(ivf.p_win),
        "block": DENSE_BLOCK,  # the plain dense probe's gather block; a load keeps the port's own
        "avg_rows": float(ivf.avg_rows_per_part),
        # the live rows the built layout serves: fresh rows are live but
        # served by the fresh scan
        "built_count": int(index._count) - n_fresh,
        "centroid_width": int(ivf.centroids.shape[1]),
        "n_fresh": n_fresh,
    }


def _ivf_payload(index, ivf) -> bytes:
    """Centroids, then starts, lens and fresh slots remapped to the saved
    (compacted) positions: the dense layout keeps live rows in cluster
    order, so the live rows before each boundary give its new position."""
    cents = np.ascontiguousarray(ivf.centroids.cpu().numpy(), dtype="<f4")
    starts = ivf.starts.cpu().numpy().astype(np.int64)
    lens = ivf.lens.cpu().numpy().astype(np.int64)
    valid = index._valid.cpu().numpy()
    pre = np.zeros(len(valid) + 1, dtype=np.int64)
    np.cumsum(valid, out=pre[1:])
    new_starts = pre[np.clip(starts, 0, len(valid))]
    new_lens = pre[np.clip(starts + lens, 0, len(valid))] - new_starts
    fresh = pre[np.asarray(ivf.fresh_np, dtype=np.int64)]
    return cents.tobytes() + b"".join(np.ascontiguousarray(a, dtype="<i4").tobytes()
                                      for a in (new_starts, new_lens, fresh))


def _head_bytes(header_dict: dict) -> bytes:
    header = json.dumps(header_dict).encode()
    return MAGIC + FORMAT_VERSION.to_bytes(2, "little") + (0).to_bytes(2, "little") + len(header).to_bytes(
        4, "little") + header


def _serialize(index):
    """(head bytes, keys, rows, IVF payload) of a save."""
    rows = _logical_rows_np(index)
    keys = index._live_keys().astype("<u8")
    header_dict = _header_dict(index, len(keys))
    ivf = _saved_ivf(index)
    payload = b""
    if ivf is not None:
        header_dict["ivf"] = _ivf_head(index, ivf)
        payload = _ivf_payload(index, ivf)
    return _head_bytes(header_dict), keys, rows, payload


def serialized_length(index) -> int:
    """The exact byte length `save_index_to_buffer` gives, from counts and
    shapes alone: no rows are read."""
    header_dict = _header_dict(index, index._count)
    payload_len = 0
    ivf = _saved_ivf(index)
    if ivf is not None:
        head = header_dict["ivf"] = _ivf_head(index, ivf)
        payload_len = head["n_chunks"] * (head["centroid_width"] * 4 + 8) + head["n_fresh"] * 4
    return len(_head_bytes(header_dict)) + index._count * (8 + index._logical_row_bytes()) + payload_len


def save_index(index, path: str) -> None:
    """Write ``index`` to a file beside ``path``, then move it into place:
    a streamed view's rows are the map of the file it may be saved over,
    which must stay whole until the rows are read."""
    head, keys, rows, payload = _serialize(index)
    tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(head)
            f.write(keys.tobytes())
            f.write(np.ascontiguousarray(rows).data)
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_index_to_buffer(index) -> bytes:
    head, keys, rows, payload = _serialize(index)
    return b"".join([head, keys.tobytes(), np.ascontiguousarray(rows).tobytes(), payload])


def _parse_header(raw: bytes):
    if raw[:12] != MAGIC:
        raise ValueError("Not a usearch_tpu index (bad magic)")
    version = int.from_bytes(raw[12:14], "little")
    if version > FORMAT_VERSION:
        raise ValueError(f"Unsupported format version {version}")
    hlen = int.from_bytes(raw[16:20], "little")
    meta = json.loads(raw[20 : 20 + hlen].decode())
    return meta, 20 + hlen


# ---------------------------------------------------------------------------
# The upstream format (.usearch files of unum-cloud/usearch).
#
# Layout (reference include/usearch/index_dense.hpp:995-1062, 24-119 and
# index.hpp:3277-3317, 1863-1869): [u32 rows, u32 cols_bytes] + rows x cols
# vector matrix, then a 64-byte head ("usearch" magic + u16 x 3 version +
# 4 x u8 kind enums + u64 count_present/count_deleted/dimensions + bool
# multi), then the HNSW graph stream: 5 x u64 header (size, connectivity,
# connectivity_base, max_level, entry_slot), size x i16 levels, and per-node
# tapes [u64 key][i16 level][neighbor blocks]. Import keeps the keys, the
# vectors and the configuration and drops the graph; deleted nodes carry the
# free key (u64 max) and are skipped.
# ---------------------------------------------------------------------------

_REF_MAGIC = b"usearch"
_REF_METRICS = {
    ord("i"): "ip", ord("c"): "cos", ord("e"): "l2sq", ord("p"): "pearson",
    ord("h"): "haversine", ord("d"): "divergence", ord("b"): "hamming",
    ord("t"): "tanimoto", ord("s"): "sorensen", ord("j"): "jaccard",
}
_REF_SCALARS = {1: "b1", 4: "bf16", 10: "f64", 11: "f32", 12: "f16", 23: "i8"}
_REF_SLOT_BYTES = {15: 4, 2: 5, 14: 8, 16: 2}  # u32 / u40 / u64 / u16
_REF_FREE_KEY = (1 << 64) - 1
_REF_METRIC_CODES = {name: code for code, name in _REF_METRICS.items()}
_REF_SCALAR_CODES = {name: code for code, name in _REF_SCALARS.items()}
_REF_KIND_KEY_U64 = 14   # scalar_kind_t::u64_k (index_plugins.hpp:151)
_REF_KIND_SLOT_U32 = 15  # scalar_kind_t::u32_k (index_plugins.hpp:152)


def _ref_parse_head(buf: bytes) -> dict:
    """The 64-byte upstream head as a dict; ValueError on a bad magic or an
    unknown kind."""
    if buf[:7] != _REF_MAGIC:
        raise ValueError("not a reference-format head")
    vmaj, vmin, vpat = struct.unpack_from("<HHH", buf, 7)
    kind_metric, kind_scalar, _kind_key, kind_slot = buf[13:17]
    count_present, count_deleted, dimensions = struct.unpack_from("<QQQ", buf, 17)
    if kind_metric not in _REF_METRICS or kind_scalar not in _REF_SCALARS:
        raise ValueError(f"unsupported reference kinds metric={kind_metric} scalar={kind_scalar}")
    return {
        "version": f"{vmaj}.{vmin}.{vpat}",
        "metric": _REF_METRICS[kind_metric],
        "dtype": _REF_SCALARS[kind_scalar],
        "slot_bytes": _REF_SLOT_BYTES.get(kind_slot, 4),
        "count": count_present,
        "count_deleted": count_deleted,
        "ndim": dimensions,
        "multi": bool(buf[41]),
    }


def _ref_sniff(raw_head: bytes, total_len: int):
    """Where the upstream 64-byte head lies: (head offset, matrix offset,
    rows, cols, 64-bit dims) or None. The three probes of
    index_dense_metadata_from_path (index_dense.hpp:253-369): head first
    (vectors excluded), u32 matrix dims, u64 matrix dims."""
    if raw_head[:7] == _REF_MAGIC:
        return 0, None, 0, 0, False
    for fmt, width, dims64 in (("<II", 8, False), ("<QQ", 16, True)):
        if len(raw_head) < width:
            continue
        rows, cols = struct.unpack_from(fmt, raw_head, 0)
        off = width + rows * cols
        if cols and off + 64 <= total_len:
            return off, width, rows, cols, dims64
    return None


def _read_source(path_or_buffer) -> bytes:
    if isinstance(path_or_buffer, (bytes, bytearray, memoryview)):
        return path_or_buffer
    with open(os.fspath(path_or_buffer), "rb") as f:
        return f.read()


def load_reference_index(index, path_or_buffer) -> None:
    """Import an upstream `.usearch` file or buffer into ``index``: keys,
    vectors, metric, dtype, ndim and multi; the graph is read for its keys
    and dropped. ValueError when the source is not one, or was saved with
    its vectors excluded."""
    raw = _read_source(path_or_buffer)
    sniffed = _ref_sniff(bytes(raw[:16]), len(raw))
    if sniffed is None:
        raise ValueError("Not a reference-format usearch index")
    head_off, mat_off, rows, cols, _dims64 = sniffed
    if mat_off is None:
        raise ValueError("reference file has vectors excluded (exclude_vectors=true): "
                         "nothing to import without the matrix")
    meta = _ref_parse_head(bytes(raw[head_off : head_off + 64]))
    per_row, dt = _file_layout(normalize_dtype(meta["dtype"]), meta["ndim"])
    if per_row * np.dtype(dt).itemsize != cols:
        raise ValueError(f"matrix row stride {cols} B != {per_row}x{np.dtype(dt).itemsize} B expected "
                         f"for {meta['dtype']} at {meta['ndim']}d")
    mat = np.frombuffer(raw, dtype=dt, count=rows * per_row, offset=mat_off).reshape(rows, per_row)

    # node keys from the graph stream after the head; block sizes from the
    # graph header's own connectivity (index.hpp:3731-3747, 2085)
    graph_off = head_off + 64
    size, conn, connb = struct.unpack_from("<QQQ", raw, graph_off)
    if rows and size != rows:
        raise ValueError(f"graph size {size} != matrix rows {rows}")
    levels = np.frombuffer(raw, dtype="<i2", count=size, offset=graph_off + 40)
    keys = np.empty(size, dtype=np.uint64)
    pos = graph_off + 40 + 2 * size
    base_bytes = connb * meta["slot_bytes"] + 4
    upper_bytes = conn * meta["slot_bytes"] + 4
    for i in range(size):
        keys[i] = struct.unpack_from("<Q", raw, pos)[0]
        pos += 10 + base_bytes + int(levels[i]) * upper_bytes
    live = keys != np.uint64(_REF_FREE_KEY)
    if meta["count_deleted"] == 0:
        live[:] = True
    pmeta = {"metric": meta["metric"], "dtype": meta["dtype"], "ndim": meta["ndim"], "count": int(live.sum()),
             "multi": meta["multi"]}
    _populate(index, pmeta, keys[live], mat[live])


def save_reference_index(index, path_or_buffer=None):
    """Export ``index`` as an upstream `.usearch` file that the upstream
    library loads: the rows in their stored dtype, the 64-byte head, and a
    flat graph (every node at level 0, no neighbours), which it parses and
    serves through its exact search or relinks. Returns the bytes when
    ``path_or_buffer`` is None, else writes the file."""
    if index._is_set_index:
        raise ValueError("set indexes have no reference-format equivalent")
    metric, dtype = index._metric_kind.value, index._dtype.value
    if metric not in _REF_METRIC_CODES:
        raise ValueError(f"metric {metric!r} has no reference metric_kind_t code")
    if dtype not in _REF_SCALAR_CODES:
        raise ValueError(f"dtype {dtype!r} has no reference scalar_kind_t code")
    rows = _logical_rows_np(index)
    keys = index._live_keys().astype("<u8")
    n = len(keys)
    out = bytearray(struct.pack("<II", n, index._logical_row_bytes()))
    out += np.ascontiguousarray(rows).tobytes()

    head = bytearray(64)
    head[0:7] = _REF_MAGIC
    struct.pack_into("<HHH", head, 7, *(int(x) for x in LIBRARY_VERSION.split("+")[0].split(".")))
    head[13] = _REF_METRIC_CODES[metric]
    head[14] = _REF_SCALAR_CODES[dtype]
    head[15] = _REF_KIND_KEY_U64
    head[16] = _REF_KIND_SLOT_U32
    struct.pack_into("<QQQ", head, 17, n, 0, index._ndim)
    head[41] = 1 if index._multi else 0
    out += head

    conn = max(int(index._connectivity), 1)
    conn_base = 2 * conn  # the reference's connectivity_base default ratio
    out += struct.pack("<QQQQQ", n, conn, conn_base, 0, 0)
    out += np.zeros(n, dtype="<i2").tobytes()  # every node at level 0
    # node tapes: u64 key, i16 level, u32 neighbour count, zeroed slots
    tape = np.zeros((n, 10 + 4 + 4 * conn_base), dtype=np.uint8)
    tape[:, 0:8] = keys.view(np.uint8).reshape(n, 8)
    out += tape.tobytes()
    if path_or_buffer is None:
        return bytes(out)
    with open(os.fspath(path_or_buffer), "wb") as f:
        f.write(out)
    return None


def index_metadata(path_or_buffer) -> dict:
    """A file's or buffer's configuration, read without its rows (the
    counterpart of the reference's `index_dense_metadata_from_path`)."""
    if isinstance(path_or_buffer, (bytes, bytearray, memoryview)):
        raw = bytes(path_or_buffer[:4096])
        total = len(path_or_buffer)
    else:
        p = os.fspath(path_or_buffer)
        with open(p, "rb") as f:
            raw = f.read(4096)
        total = os.path.getsize(p)
    if raw[:12] != MAGIC:
        sniffed = _ref_sniff(raw[:16], total)
        if sniffed is not None:
            head_off, mat_off, _rows, _cols, dims64 = sniffed
            if isinstance(path_or_buffer, (bytes, bytearray, memoryview)):
                hb = bytes(path_or_buffer[head_off : head_off + 64])
            else:
                with open(p, "rb") as f:
                    f.seek(head_off)
                    hb = f.read(64)
            rmeta = _ref_parse_head(hb)
            return {
                "matrix_included": mat_off is not None,
                "matrix_uses_64_bit_dimensions": dims64,
                "version": rmeta["version"],
                "kind_metric": rmeta["metric"],
                "kind_scalar": rmeta["dtype"],
                "kind_key": "u64",
                "kind_compressed_slot": f"u{rmeta['slot_bytes'] * 8}",
                "count_present": rmeta["count"],
                "count_deleted": rmeta["count_deleted"],
                "dimensions": rmeta["ndim"],
                "multi": rmeta["multi"],
                "metric": rmeta["metric"],
                "dtype": rmeta["dtype"],
                "format": "reference",
            }
    meta, _ = _parse_header(raw)
    return {
        "matrix_included": True,
        "matrix_uses_64_bit_dimensions": False,
        "version": meta.get("library_version", LIBRARY_VERSION),
        "kind_metric": meta["metric"],
        "kind_scalar": meta["dtype"],
        "kind_key": "u64",
        "kind_compressed_slot": "u32",
        "count_present": meta["count"],
        "count_deleted": 0,
        "dimensions": meta["ndim"],
        "multi": meta.get("multi", False),
        "metric": meta["metric"],
        "dtype": meta["dtype"],
    }


def _rows_from_bytes(buf, offset: int, meta: dict) -> np.ndarray:
    per_row, dt = _file_layout(normalize_dtype(meta["dtype"]), meta["ndim"], bool(meta.get("set_index")))
    count = meta["count"]
    return np.frombuffer(buf, dtype=dt, count=count * per_row, offset=offset).reshape(count, per_row)


def _load_arrays(source, view: bool):
    """(meta, keys u64 [N], rows [N, columns]) of a native file or buffer;
    ``view`` maps the file's rows instead of reading them."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        meta, off = _parse_header(bytes(source[:4096]))
        count = meta["count"]
        keys = np.frombuffer(source, dtype="<u8", count=count, offset=off)
        return meta, keys, _rows_from_bytes(source, off + count * 8, meta)
    path = os.fspath(source)
    with open(path, "rb") as f:
        meta, off = _parse_header(f.read(4096))
        count = meta["count"]
        if view:
            keys = np.fromfile(path, dtype="<u8", count=count, offset=off)
            if count == 0:
                return meta, keys, _rows_from_bytes(b"", 0, meta)
            rows = _rows_from_bytes(np.memmap(path, dtype=np.uint8, mode="r", offset=off + count * 8), 0, meta)
        else:
            f.seek(off)
            keys = np.frombuffer(f.read(count * 8), dtype="<u8")
            rows = _rows_from_bytes(f.read(), 0, meta)
    return meta, keys, rows


def _device_memory_budget(index) -> int:
    """The index's device memory in bytes; 0 on the CPU."""
    if index._device.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(index._device)[1])


def load_index_into(index, path: str, view: bool = False, stream=None) -> None:
    with open(os.fspath(path), "rb") as f:
        sig = f.read(16)
    if sig[:12] != MAGIC and _ref_sniff(sig, os.path.getsize(os.fspath(path))):
        # an upstream file: imported whole, never mapped
        load_reference_index(index, path)
        return
    meta, keys, rows = _load_arrays(path, view)
    if view and stream is None:
        budget = _device_memory_budget(index)
        stream = bool(budget) and rows.nbytes > STREAM_SHARE * budget
    if meta["dtype"] == "f64" and not meta.get("set_index"):
        stream = False  # f64 rows serve from the device's f32 table, as in the JAX package
    if view and stream:
        _configure(index, meta)
        index._bulk_install_streamed(keys, rows)  # the file's IVF stays unused: a streamed search is exact
        return
    _populate(index, meta, keys, rows)
    _restore_ivf(index, meta, path, rows)


def load_index_from_buffer(index, buffer) -> None:
    if bytes(buffer[:12]) != MAGIC and _ref_sniff(bytes(buffer[:16]), len(buffer)):
        load_reference_index(index, buffer)
        return
    meta, keys, rows = _load_arrays(buffer, view=False)
    _populate(index, meta, keys, rows)
    _restore_ivf(index, meta, buffer, rows)


def _ivf_tail(source, meta: dict, rows: np.ndarray):
    """The IVF payload's arrays (centroids, starts, lens, fresh), or None
    when the source is cut short."""
    info = meta["ivf"]
    c, wc, n_fresh = int(info["n_chunks"]), int(info["centroid_width"]), int(info.get("n_fresh", 0))
    sizes = ((np.dtype("<f4"), c * wc), (np.dtype("<i4"), c), (np.dtype("<i4"), c), (np.dtype("<i4"), n_fresh))
    if isinstance(source, (bytes, bytearray, memoryview)):
        _, off = _parse_header(bytes(source[:4096]))
        tail = off + meta["count"] * 8 + rows.nbytes
        if len(source) < tail + sum(dt.itemsize * n for dt, n in sizes):
            return None
        out = []
        for dt, n in sizes:
            out.append(np.frombuffer(source, dtype=dt, count=n, offset=tail))
            tail += dt.itemsize * n
        return out
    path = os.fspath(source)
    with open(path, "rb") as f:
        _, off = _parse_header(f.read(4096))
        f.seek(off + meta["count"] * 8 + rows.nbytes)
        out = [np.fromfile(f, dtype=dt, count=n) for dt, n in sizes]
    return out if all(a.size == n for a, (_, n) in zip(out, sizes)) else None


def _restore_ivf(index, meta: dict, source, rows: np.ndarray) -> None:
    """Give ``index`` the dense IVF its file holds: a loaded index serves
    its partitions without a new k-means fit. A source cut short inside the
    IVF payload loads without it."""
    if not meta.get("ivf"):
        return
    tail = _ivf_tail(source, meta, rows)
    if tail is None:
        return
    info = meta["ivf"]
    cents, starts, lens, fresh = tail
    c, p_win, dev = int(info["n_chunks"]), int(info["p_win"]), index._device
    index._ivf = IVFPartitions(
        centroids=torch.as_tensor(cents.reshape(c, int(info["centroid_width"])).copy(), device=dev),
        part_table=None, part_stats=None, part_slots=None, avg_rows=float(info["avg_rows"]),
        built_count=int(info["built_count"]), inplace_shape=(c, p_win),
        starts=torch.as_tensor(starts.copy(), device=dev), lens=torch.as_tensor(lens.copy(), device=dev),
        p_win=p_win,
    )
    index._ivf.fresh_np = fresh.astype(np.int64)
    index._ivf_dirty = False


def _configure(index, meta: dict) -> None:
    """Configure ``index`` anew, empty, from a file's header."""
    index.__init__(
        ndim=meta["ndim"],
        metric=meta["metric"],
        dtype=None if meta.get("set_index") else meta["dtype"],
        connectivity=meta.get("connectivity", index._connectivity),
        expansion_add=meta.get("expansion_add", index._expansion_add),
        expansion_search=meta.get("expansion_search", index._expansion_search),
        multi=bool(meta.get("multi", False)),
        device=index._device,
    )


def load_streamed_rows(view, index) -> None:
    """Install a streamed view's keys and rows (read from its map) in
    ``index``, configured anew as the view and resident on its device."""
    _populate(index, _header_dict(view, view._count), view._slot_keys, view._stream_rows)


def _populate(index, meta: dict, keys: np.ndarray, rows: np.ndarray) -> None:
    """Configure ``index`` from a file's header and install its rows at
    slots ``0..count``, in their stored representation (no cast; f64 rows
    rounded to the device's f32, with the exact host copy beside), chunk by
    chunk onto the device; the key map is rebuilt from the keys."""
    _configure(index, meta)
    count = int(meta["count"])
    if count == 0:
        return
    index.reserve(count)
    cols = rows.shape[1]
    if index._is_set_index:
        index._table[:, cols:] = -1
    if index._dtype == ScalarKind.F64:
        index._host_f64 = np.zeros((index._capacity, index._ndim), dtype=np.float64)
        index._host_f64[:count] = rows
    for lo in range(0, count, ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, count)
        chunk = torch.from_numpy(np.array(rows[lo:hi]))  # a writable copy of (mapped) file bytes
        if index._dtype == ScalarKind.BF16:
            chunk = chunk.view(torch.bfloat16)
        index._table[lo:hi, :cols] = chunk.to(index._device)
        index._stats[lo:hi] = row_stats(index._table[lo:hi], index._kind)
    index._valid[:count] = True
    slots = np.arange(count, dtype=np.int64)
    index._slot_keys[:count] = keys
    index._keymap.insert_many(np.asarray(keys, dtype=np.uint64), slots)
    index._next_slot = count
    index._count = count
