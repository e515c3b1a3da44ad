"""Client of `server.IndexServer` over HTTP and JSON (reference:
python/usearch/client.py:1-120, the same add/search/get surface).

Counterpart of `usearch_tpu/client.py`; it talks to the server of either
package."""

from __future__ import annotations

import json
import urllib.request
from typing import Optional

import numpy as np

from .matches import BatchMatches
from .server import decode_array, encode_array


class IndexClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5555, timeout: float = 30.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def _call(self, method: str, **kwargs):
        body = json.dumps(kwargs).encode()
        req = urllib.request.Request(
            f"{self.base}/{method}", data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as exc:  # server-reported error payloads
            try:
                out = json.loads(exc.read())
            except Exception:
                raise RuntimeError(f"HTTP {exc.code}") from exc
        if not out.get("ok"):
            raise RuntimeError(out.get("error", "server error"))
        return out["result"]

    def __len__(self) -> int:
        return int(self._call("size"))

    @property
    def info(self) -> dict:
        return self._call("info")

    @property
    def ndim(self) -> int:
        return int(self.info["ndim"])

    def add(self, keys, vectors) -> np.ndarray:
        payload = {
            "keys": None if keys is None else encode_array(np.atleast_1d(np.asarray(keys, np.uint64))),
            "vectors": encode_array(np.asarray(vectors)),
        }
        return decode_array(self._call("add", **payload))

    def search(self, vectors, count: int = 10, exact: bool = False) -> BatchMatches:
        out = self._call(
            "search", vectors=encode_array(np.asarray(vectors)), count=count, exact=exact
        )
        return BatchMatches(
            keys=decode_array(out["keys"]),
            distances=decode_array(out["distances"]),
            counts=decode_array(out["counts"]),
        )

    def get(self, keys) -> Optional[np.ndarray]:
        out = self._call("get", keys=encode_array(np.atleast_1d(np.asarray(keys, np.uint64))))
        if out is None:
            return None
        if isinstance(out, list):
            return [None if o is None else decode_array(o) for o in out]
        return decode_array(out)

    def remove(self, keys) -> np.ndarray:
        return decode_array(
            self._call("remove", keys=encode_array(np.atleast_1d(np.asarray(keys, np.uint64))))
        )

    def contains(self, keys) -> np.ndarray:
        return decode_array(
            self._call("contains", keys=encode_array(np.atleast_1d(np.asarray(keys, np.uint64))))
        )
