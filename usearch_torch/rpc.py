"""Binary RPC server and client for a single Index: the serving path, in
place of the reference's UCall-based server (reference:
python/usearch/server.py:131, client.py:120). Length-prefixed binary frames
over a persistent TCP connection; vectors travel as raw C-order bytes (no
JSON parse, no base64: the HTTP envelope of server.py inflates payloads by
a third and parses each call anew).

Counterpart of `usearch_tpu/rpc.py`, byte for byte on the wire, so a client
of either package talks to a server of the other.

Wire format (little-endian):
  frame   := magic "UTPB" | u8 op | u8 status | u16 reserved | u32 n_sections
             | section*
  section := u32 byte_len | payload
  array   := u8 dtype_code | u8 rank | u32 dims[rank] | raw C-order bytes
Requests carry op + sections; responses echo op with status 0 (ok) or 1
(error, single utf-8 message section).

Ops: 1 info, 2 size, 3 add, 4 search, 5 get, 6 remove, 7 contains.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Optional

import numpy as np

from .index import Index

_MAGIC = b"UTPB"
_HEAD = struct.Struct("<4sBBHI")

OP_INFO, OP_SIZE, OP_ADD, OP_SEARCH, OP_GET, OP_REMOVE, OP_CONTAINS = range(1, 8)

_DTYPES = [
    np.dtype(c)
    for c in ("float32", "float64", "float16", "int8", "uint8", "int32",
              "int64", "uint32", "uint64", "bool")
]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}


def pack_array(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype
    if dt.name == "bfloat16":  # wire format sticks to numpy-native dtypes
        arr = arr.astype(np.float32)
        dt = arr.dtype
    code = _DTYPE_CODE[dt]
    head = struct.pack(f"<BB{arr.ndim}I", code, arr.ndim, *arr.shape)
    return head + arr.tobytes()


def unpack_array(buf: bytes) -> np.ndarray:
    code, rank = struct.unpack_from("<BB", buf, 0)
    dims = struct.unpack_from(f"<{rank}I", buf, 2)
    off = 2 + 4 * rank
    return np.frombuffer(buf, dtype=_DTYPES[code], offset=off).reshape(dims)


def _send_frame(sock, op: int, sections, status: int = 0) -> None:
    parts = [_HEAD.pack(_MAGIC, op, status, 0, len(sections))]
    for s in sections:
        parts.append(struct.pack("<I", len(s)))
        parts.append(s)
    sock.sendall(b"".join(parts))


def _recv_exact(sock, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        got = sock.recv(min(n, 1 << 20))
        if not got:
            return None
        chunks.append(got)
        n -= len(got)
    return b"".join(chunks)


def _recv_frame(sock):
    head = _recv_exact(sock, _HEAD.size)
    if head is None:
        return None
    magic, op, status, _, n_sections = _HEAD.unpack(head)
    if magic != _MAGIC:
        raise ValueError("bad frame magic")
    sections = []
    for _ in range(n_sections):
        (ln,) = struct.unpack("<I", _recv_exact(sock, 4))
        sections.append(_recv_exact(sock, ln))
    return op, status, sections


#: max buffered search requests per connection before the server coalesces
_PIPELINE_DEPTH = 64


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        """Persistent connection with search micro-batching: search frames
        queue while the socket has data, and consecutive requests with the
        same (k, exact, width) coalesce into one `Index.search` batch, one
        device dispatch for the whole run, split back per request for the
        responses. A stream of one-query requests then pays the fixed cost
        of a search (the host's preparation and launches, the copy of the
        results back) once per run instead of once per request. Responses
        always go out in request order; mutating ops are barriers (all
        buffered searches flush first)."""
        import select
        from collections import deque

        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        buf = deque()   # parsed, unserved: ("q", q2d, k, exact) | ("err", exc)

        def serve_buffered():
            """Coalesce + serve + respond for everything in `buf`."""
            while buf:
                kind = buf[0][0]
                if kind == "err":
                    _, exc = buf.popleft()
                    msg = f"{type(exc).__name__}: {exc}".encode()
                    _send_frame(self.request, OP_SEARCH, [msg], status=1)
                    continue
                run = [buf.popleft()]
                while (
                    buf
                    and buf[0][0] == "q"
                    and buf[0][2] == run[0][2]          # same k
                    and buf[0][3] == run[0][3]          # same exact flag
                    and buf[0][1].shape[1] == run[0][1].shape[1]
                ):
                    run.append(buf.popleft())
                qcat = (
                    run[0][1]
                    if len(run) == 1
                    else np.concatenate([r[1] for r in run])
                )
                k, exact = int(run[0][2]), bool(run[0][3])
                try:
                    with self.server.op_lock:
                        m = self.server.index.search(qcat, k, exact=exact)
                    keys = np.asarray(m.keys)
                    dists = np.asarray(m.distances)
                    counts = np.asarray(m.counts)
                    off = 0
                    for r in run:
                        n = r[1].shape[0]
                        sl = slice(off, off + n)
                        _send_frame(
                            self.request, OP_SEARCH,
                            [pack_array(keys[sl]), pack_array(dists[sl]),
                             pack_array(counts[sl])],
                            status=0,
                        )
                        off += n
                except ConnectionError:
                    raise
                except Exception as exc:
                    msg = f"{type(exc).__name__}: {exc}".encode()
                    for _r in run:
                        _send_frame(self.request, OP_SEARCH, [msg], status=1)

        while True:
            if buf:
                ready, _, _ = select.select([self.request], [], [], 0)
                if not ready or len(buf) >= _PIPELINE_DEPTH:
                    try:
                        serve_buffered()
                    except ConnectionError:
                        return
                    continue
            try:
                frame = _recv_frame(self.request)
            except (ConnectionError, ValueError):
                return
            if frame is None:
                try:
                    serve_buffered()  # flush what the client is still owed
                except ConnectionError:
                    pass
                return
            op, _, sections = frame
            if op == OP_SEARCH:
                try:
                    vectors = np.atleast_2d(unpack_array(sections[0]))
                    k, exact = struct.unpack("<IB", sections[1])
                    buf.append(("q", vectors, k, exact))
                except Exception as exc:
                    buf.append(("err", exc))
                continue
            # non-search ops are barriers: preserve response order
            try:
                serve_buffered()
            except ConnectionError:
                return
            try:
                out = self._dispatch(op, sections)
                _send_frame(self.request, op, out, status=0)
            except Exception as exc:  # surface errors to the client
                msg = f"{type(exc).__name__}: {exc}".encode()
                try:
                    _send_frame(self.request, op, [msg], status=1)
                except ConnectionError:
                    return

    def _dispatch(self, op: int, sections):
        index: Index = self.server.index
        lock: threading.Lock = self.server.op_lock
        if op == OP_INFO:
            info = {
                "ndim": index.ndim,
                "metric": index.metric_kind.value,
                "dtype": index.dtype.value,
                "size": len(index),
                "multi": index.multi,
            }
            return [json.dumps(info).encode()]
        if op == OP_SIZE:
            return [struct.pack("<Q", len(index))]
        with lock:
            if op == OP_ADD:
                keys = unpack_array(sections[0]) if sections[0] else None
                vectors = unpack_array(sections[1])
                added = index.add(keys, vectors)
                return [pack_array(np.atleast_1d(np.asarray(added, np.uint64)))]
            if op == OP_GET:
                keys = unpack_array(sections[0])
                got = index.get(keys)
                if got is None:
                    return [b""]
                if isinstance(got, np.ndarray):
                    return [pack_array(got)]
                return [b"" if g is None else pack_array(g) for g in got]
            if op == OP_REMOVE:
                removed = index.remove(unpack_array(sections[0]))
                return [pack_array(np.atleast_1d(np.asarray(removed, np.uint64)))]
            if op == OP_CONTAINS:
                return [pack_array(np.atleast_1d(index.contains(unpack_array(sections[0]))))]
        raise ValueError(f"unknown op {op}")


class BinaryIndexServer:
    """Serve one Index over the binary protocol. `start()` spawns a daemon
    thread; `serve_forever()` blocks."""

    def __init__(self, index: Index, host: str = "127.0.0.1", port: int = 5556):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.srv = _Srv((host, port), _Handler)
        self.srv.index = index
        self.srv.op_lock = threading.Lock()
        self.host = host
        self.port = self.srv.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "BinaryIndexServer":
        self._thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):  # pragma: no cover - blocking entry
        self.srv.serve_forever()

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()


class BinaryIndexClient:
    """Client mirroring `client.IndexClient` over the binary wire."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5556, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def close(self):
        try:
            self.sock.close()
        except OSError:  # pragma: no cover
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, op: int, sections):
        with self._lock:
            _send_frame(self.sock, op, sections)
            frame = _recv_frame(self.sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        _, status, out = frame
        if status != 0:
            raise RuntimeError(out[0].decode() if out else "remote error")
        return out

    def info(self) -> dict:
        return json.loads(self._call(OP_INFO, [])[0])

    def __len__(self) -> int:
        (raw,) = self._call(OP_SIZE, [])
        return struct.unpack("<Q", raw)[0]

    def add(self, keys, vectors) -> np.ndarray:
        ks = pack_array(np.asarray(keys, np.uint64)) if keys is not None else b""
        (out,) = self._call(OP_ADD, [ks, pack_array(np.asarray(vectors))])
        return unpack_array(out)

    def search(self, vectors, count: int = 10, exact: bool = False):
        from .matches import BatchMatches

        single = np.asarray(vectors).ndim == 1
        out = self._call(
            OP_SEARCH,
            [pack_array(np.atleast_2d(np.asarray(vectors))),
             struct.pack("<IB", count, 1 if exact else 0)],
        )
        keys, dists, counts = (unpack_array(s) for s in out)
        bm = BatchMatches(keys=keys, distances=dists, counts=counts.astype(np.uint64))
        return bm[0] if single else bm

    def search_pipelined(self, batches, count: int = 10, exact: bool = False):
        """Submit MANY search requests back-to-back on this connection and
        read the responses afterwards: the server coalesces those that
        arrive together into one search (see _Handler.handle), so a stream
        of small requests shares the fixed cost of a dispatch. Returns one
        BatchMatches per input batch, in order."""
        from .matches import BatchMatches

        batches = [np.atleast_2d(np.asarray(b)) for b in batches]
        results = []
        first_err = None

        def drain_one():
            nonlocal first_err
            frame = _recv_frame(self.sock)
            if frame is None:
                raise ConnectionError("server closed the connection")
            _, status, out = frame
            if status != 0:
                if first_err is None:
                    first_err = RuntimeError(
                        out[0].decode() if out else "remote error"
                    )
                results.append(None)
                return
            keys, dists, counts = (unpack_array(s) for s in out)
            results.append(BatchMatches(
                keys=keys, distances=dists, counts=counts.astype(np.uint64)
            ))

        with self._lock:
            # keep at most _PIPELINE_DEPTH requests in flight: an unbounded
            # write burst can fill BOTH sockets' TCP buffers (the server
            # flushes responses while we are still sending) and deadlock
            # with each side blocked in send
            in_flight = 0
            for b in batches:
                if in_flight >= _PIPELINE_DEPTH:
                    drain_one()
                    in_flight -= 1
                _send_frame(
                    self.sock, OP_SEARCH,
                    [pack_array(b), struct.pack("<IB", count, 1 if exact else 0)],
                )
                in_flight += 1
            for _ in range(in_flight):  # drain EVERY response (stream sync)
                drain_one()
        if first_err is not None:
            raise first_err
        return results

    def get(self, keys):
        keys = np.atleast_1d(np.asarray(keys, np.uint64))
        out = self._call(OP_GET, [pack_array(keys)])
        arrays = [None if not s else unpack_array(s) for s in out]
        if len(arrays) == 1 and arrays[0] is not None and arrays[0].ndim == 2:
            return arrays[0]
        return arrays

    def remove(self, keys) -> np.ndarray:
        (out,) = self._call(OP_REMOVE, [pack_array(np.atleast_1d(np.asarray(keys, np.uint64)))])
        return unpack_array(out)

    def contains(self, keys) -> np.ndarray:
        (out,) = self._call(OP_CONTAINS, [pack_array(np.atleast_1d(np.asarray(keys, np.uint64)))])
        return unpack_array(out)


def main():  # pragma: no cover - CLI entry
    import argparse

    parser = argparse.ArgumentParser(description="usearch_torch binary index server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("-p", "--port", type=int, default=5556)
    parser.add_argument("--ndim", type=int)
    parser.add_argument("--metric", default="cos")
    parser.add_argument("--dtype", default=None)
    parser.add_argument("--path", default=None, help="restore an existing index file")
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = parser.parse_args()

    if args.path:
        index = Index.restore(args.path, device=args.device)
    else:
        index = Index(ndim=args.ndim, metric=args.metric, dtype=args.dtype, device=args.device)
    print(f"Serving {index} on {args.host}:{args.port} (binary)")
    BinaryIndexServer(index, args.host, args.port).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
