"""Single-index server over HTTP and JSON: the reference's remote surface
(reference: python/usearch/server.py:1-131), add / search / get / remove /
contains / size / info, with the standard library alone.

Counterpart of `usearch_tpu/server.py`, field for field: arrays travel as
base64-encoded ``.npy`` payloads inside the JSON envelope, so a client of
either package talks to a server of the other. `rpc.py` is the binary
serving path; this one is the debug-friendly surface.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .index import Index


def encode_array(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode()


def decode_array(payload: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(payload)), allow_pickle=False)


class _Handler(BaseHTTPRequestHandler):
    index: Index = None
    lock: threading.Lock = None

    def log_message(self, fmt, *args):  # pragma: no cover - quiet server
        pass

    def _reply(self, obj, status=200):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 - http.server API
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            method = self.path.strip("/")
            with self.lock:
                out = self._dispatch(method, req)
            self._reply({"ok": True, "result": out})
        except Exception as exc:  # pragma: no cover - error path
            self._reply({"ok": False, "error": f"{type(exc).__name__}: {exc}"}, status=400)

    def _dispatch(self, method: str, req: dict):
        index = self.index
        if method == "size":
            return len(index)
        if method == "info":
            return {
                "ndim": index.ndim,
                "metric": index.metric_kind.value,
                "dtype": index.dtype.value,
                "size": len(index),
                "multi": index.multi,
            }
        if method == "add":
            keys = decode_array(req["keys"]) if req.get("keys") is not None else None
            vectors = decode_array(req["vectors"])
            added = index.add(keys, vectors)
            return encode_array(np.atleast_1d(np.asarray(added, dtype=np.uint64)))
        if method == "search":
            vectors = decode_array(req["vectors"])
            m = index.search(np.atleast_2d(vectors), int(req.get("count", 10)),
                             exact=bool(req.get("exact", False)))
            return {
                "keys": encode_array(m.keys),
                "distances": encode_array(m.distances),
                "counts": encode_array(m.counts),
            }
        if method == "get":
            keys = decode_array(req["keys"])
            got = index.get(keys)
            if got is None:
                return None
            if isinstance(got, np.ndarray):
                return encode_array(got)
            return [None if g is None else encode_array(g) for g in got]
        if method == "remove":
            keys = decode_array(req["keys"])
            removed = index.remove(keys)
            return encode_array(np.atleast_1d(np.asarray(removed, dtype=np.uint64)))
        if method == "contains":
            keys = decode_array(req["keys"])
            return encode_array(np.atleast_1d(index.contains(keys)))
        raise ValueError(f"Unknown method: {method}")


class IndexServer:
    """Serve one Index over HTTP. `serve_forever()` blocks; `start()` spawns
    a daemon thread (used by tests and embedding apps)."""

    def __init__(self, index: Index, host: str = "127.0.0.1", port: int = 5555):
        handler = type("BoundHandler", (_Handler,), {"index": index, "lock": threading.Lock()})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "IndexServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):  # pragma: no cover - blocking entry
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main():  # pragma: no cover - CLI entry
    import argparse

    parser = argparse.ArgumentParser(description="usearch_torch index server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("-p", "--port", type=int, default=5555)
    parser.add_argument("--ndim", type=int, required=True)
    parser.add_argument("--metric", default="cos")
    parser.add_argument("--dtype", default=None)
    parser.add_argument("--path", default=None, help="restore an existing index file")
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = parser.parse_args()

    if args.path:
        index = Index.restore(args.path, device=args.device)
    else:
        index = Index(ndim=args.ndim, metric=args.metric, dtype=args.dtype, device=args.device)
    print(f"Serving {index} on {args.host}:{args.port}")
    IndexServer(index, args.host, args.port).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
