"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. Builds run
at first use into ``usearch_torch/_build/`` (not tracked by git), named by a
hash of the source, the ``csrc/*.cuh`` headers and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. A missing ``nvcc`` or a failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of every entry point, by source.
SIGNATURES = {
    "scan": {
        "usearch_binned_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "usearch_binned_minima": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "rescore": {
        "usearch_block_dots": [_P] * 4 + [_I] * 5 + [_P],
    },
    "bitscan": {
        "usearch_bit_scan": [_P] * 9 + [_I] * 10 + [_P],
    },
    "probe": {
        "usearch_grouped_probe": [_P] * 9 + [_I] * 7 + [_P],
        "usearch_grouped_probe_nofold": [_P] * 10 + [_I] * 7 + [_P],
        "usearch_binned_probe": [_P] * 5 + [_I] * 7 + [_P],
        "usearch_pair_lists": [_P] * 9 + [_I] * 7 + [_P],
    },
    "pair": {
        "usearch_pair_fold": [_P] * 6 + [_I] * 4 + [_P],
    },
    "fused": {
        "usearch_fused_topk": [_P] * 7 + [_I] * 6 + [_P],
        "usearch_fused_topk_stream": [_P] * 7 + [_I] * 7 + [_P],
        "usearch_binned_scan_lanes": [_P] * 7 + [_I] * 5 + [_P],
    },
    "matmul_probe": {
        "usearch_loop_matmul": [_P] * 5 + [_I] * 9 + [_P],
        "usearch_loop_chain": [_P] * 5 + [_I] * 9 + [_P],
    },
    "select": {
        "usearch_select_loop": [_P] * 2 + [_I] * 4 + [_P],
        "usearch_select_blocks": [_I, _I, _P],
    },
    "bisect": {
        "usearch_bisect_probe": [_P] * 5 + [_I] * 7 + [_F, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per source: seconds the build took (0.0 when reused) and nvcc's report
build_log: Dict[str, dict] = {}


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):  # the headers a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together; returns the library paths."""
    names = list(names)
    targets = {n: _target(n) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    for n in names:
        if n not in todo:
            build_log.setdefault(n, {"seconds": 0.0, "report": "reused"})
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        report, _ = proc.communicate()
        build_log[n] = {"seconds": time.perf_counter() - t0, "report": report}
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{report}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
