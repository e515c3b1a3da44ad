"""The C ABI over `usearch_torch`: ``libusearch_torch.so``, its header and
the C++ wrapper.

``usearch_torch.h`` declares the functions, enums and struct of the JAX
package's ``c/usearch_tpu.h``, symbol for symbol, so every binding over that
ABI (Go, Rust, C#, Java, Swift, Objective-C, JavaScript, Wolfram and the C++
wrapper) runs over this engine by linking ``-lusearch_torch`` in place of
``-lusearch_tpu``. ``lib.cpp`` embeds CPython and drives `usearch_torch`;
indexes run on the card unless ``USEARCH_TORCH_DEVICE=cpu``.

`build` compiles ``lib.cpp`` with ``g++`` at first use into
``usearch_torch/_build/cabi/libusearch_torch.so`` (not tracked by git), under
a fixed name so that ``-L<dir> -lusearch_torch`` finds it; a stamp of the
sources' and flags' hash beside it rebuilds the library when either changes.
The flags are the running interpreter's (the includes of ``python3-config
--includes``), and the library links its shared libpython where the
interpreter has one; without one it leaves the Python symbols to the process
that loads it (a Python process, through ctypes), and `build_program`
refuses, since a standalone program could not start an interpreter. A failed
build raises; there is no fallback.

::

    lib = usearch_torch.cabi.library()   # builds, loads, types the functions
    opts = usearch_torch.cabi.InitOptions(metric_kind=2, quantization=5, dimensions=256)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional, Sequence

from ..build import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent
HEADER = SRC_DIR / "usearch_torch.h"
LIB_DIR = BUILD_DIR / "cabi"
LIBRARY = LIB_DIR / "libusearch_torch.so"
_STAMP = LIB_DIR / "libusearch_torch.stamp"

#: only the usearch_* functions are exported, and the library's own calls
#: bind inside it, so it can share a process with libusearch_tpu.so
_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-fvisibility=hidden", "-Wl,-Bsymbolic"]


class BuildError(RuntimeError):
    """The C library or a program over it did not build or load."""


# enum values of usearch_torch.h
METRICS = {"unknown": 0, "cos": 1, "ip": 2, "l2sq": 3, "haversine": 4, "divergence": 5, "pearson": 6,
           "jaccard": 7, "hamming": 8, "tanimoto": 9, "sorensen": 10}
SCALARS = {"unknown": 0, "f32": 1, "f64": 2, "f16": 3, "bf16": 4, "i8": 5, "b1": 6}


class InitOptions(ctypes.Structure):
    """``usearch_init_options_t``."""

    _fields_ = [
        ("metric_kind", ctypes.c_int),
        ("metric", ctypes.c_void_p),
        ("quantization", ctypes.c_int),
        ("dimensions", ctypes.c_size_t),
        ("connectivity", ctypes.c_size_t),
        ("expansion_add", ctypes.c_size_t),
        ("expansion_search", ctypes.c_size_t),
        ("multi", ctypes.c_bool),
    ]


_P = ctypes.POINTER
_vp, _sz, _u64, _f32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_float
_err, _keys, _dists, _int = _P(ctypes.c_char_p), _P(_u64), _P(_f32), ctypes.c_int
#: (restype, argtypes) of every function of usearch_torch.h, as the
#: language bindings declare them (c_size_t matters: ctypes' default c_int
#: truncates 64-bit sizes and strides)
SIGNATURES = {
    "usearch_version": (ctypes.c_char_p, []),
    "usearch_init": (_vp, [_P(InitOptions), _err]),
    "usearch_free": (None, [_vp, _err]),
    "usearch_memory_usage": (_sz, [_vp, _err]),
    "usearch_hardware_acceleration": (ctypes.c_char_p, [_vp, _err]),
    "usearch_serialized_length": (_sz, [_vp, _err]),
    "usearch_save": (None, [_vp, ctypes.c_char_p, _err]),
    "usearch_load": (None, [_vp, ctypes.c_char_p, _err]),
    "usearch_view": (None, [_vp, ctypes.c_char_p, _err]),
    "usearch_metadata": (None, [ctypes.c_char_p, _P(InitOptions), _err]),
    "usearch_save_buffer": (None, [_vp, _vp, _sz, _err]),
    "usearch_load_buffer": (None, [_vp, _vp, _sz, _err]),
    "usearch_view_buffer": (None, [_vp, _vp, _sz, _err]),
    "usearch_metadata_buffer": (None, [_vp, _sz, _P(InitOptions), _err]),
    "usearch_change_threads_add": (None, [_vp, _sz, _err]),
    "usearch_change_threads_search": (None, [_vp, _sz, _err]),
    "usearch_change_metric_kind": (None, [_vp, _int, _err]),
    "usearch_change_metric": (None, [_vp, _vp, _vp, _int, _err]),
    "usearch_size": (_sz, [_vp, _err]),
    "usearch_capacity": (_sz, [_vp, _err]),
    "usearch_dimensions": (_sz, [_vp, _err]),
    "usearch_connectivity": (_sz, [_vp, _err]),
    "usearch_reserve": (None, [_vp, _sz, _err]),
    "usearch_expansion_add": (_sz, [_vp, _err]),
    "usearch_expansion_search": (_sz, [_vp, _err]),
    "usearch_change_expansion_add": (None, [_vp, _sz, _err]),
    "usearch_change_expansion_search": (None, [_vp, _sz, _err]),
    "usearch_add": (None, [_vp, _u64, _vp, _int, _err]),
    "usearch_contains": (ctypes.c_bool, [_vp, _u64, _err]),
    "usearch_count": (_sz, [_vp, _u64, _err]),
    "usearch_search": (_sz, [_vp, _vp, _int, _sz, _keys, _dists, _err]),
    "usearch_filtered_search": (_sz, [_vp, _vp, _int, _sz, _keys, _sz, _keys, _dists, _err]),
    "usearch_get": (_sz, [_vp, _u64, _sz, _vp, _int, _err]),
    "usearch_remove": (_sz, [_vp, _u64, _err]),
    "usearch_rename": (_sz, [_vp, _u64, _u64, _err]),
    "usearch_distance": (_f32, [_vp, _vp, _int, _sz, _int, _err]),
    "usearch_exact_search": (None, [_vp, _sz, _sz, _vp, _sz, _sz, _int, _sz, _int, _sz, _sz, _keys, _sz, _dists,
                                    _sz, _err]),
    "usearch_clear": (None, [_vp, _err]),
}

_lock = threading.Lock()
_loaded: Optional[ctypes.CDLL] = None


def python_link() -> Optional[list]:
    """The link flags of this interpreter's shared libpython, or None when it
    has none (a statically linked interpreter)."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return None
    libdir = sysconfig.get_config_var("LIBDIR")
    return [f"-L{libdir}", f"-lpython{sysconfig.get_config_var('LDVERSION')}", f"-Wl,-rpath,{libdir}"]


def _command(out: Path) -> list:
    paths = sysconfig.get_paths()
    includes = sorted({f"-I{paths['include']}", f"-I{paths['platinclude']}"})  # python3-config --includes
    return ["g++", *_FLAGS, *includes, "-o", str(out), str(SRC_DIR / "lib.cpp"), *(python_link() or [])]


def _run(cmd: Sequence[str], what: str) -> None:
    try:
        subprocess.run(list(cmd), check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise BuildError(f"{what}: {e}") from e
    except subprocess.CalledProcessError as e:
        raise BuildError(f"{what} failed:\n{e.stderr[-4000:]}") from e


def build() -> Path:
    """Build ``libusearch_torch.so`` unless its stamp matches the sources and
    flags; returns its path. Raises `BuildError`."""
    digest = hashlib.sha256()
    for path in (SRC_DIR / "lib.cpp", HEADER):
        digest.update(path.read_bytes())
    digest.update(" ".join(_command(LIBRARY)).encode())
    stamp = digest.hexdigest()
    with _lock:
        if LIBRARY.exists() and _STAMP.exists() and _STAMP.read_text() == stamp:
            return LIBRARY
        LIB_DIR.mkdir(parents=True, exist_ok=True)
        tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
        try:
            _run(_command(tmp), "g++ of usearch_torch/cabi/lib.cpp")
            os.replace(tmp, LIBRARY)
        finally:
            if tmp.exists():
                tmp.unlink()
        stamp_tmp = _STAMP.with_name(f"{_STAMP.name}.{os.getpid()}.tmp")
        stamp_tmp.write_text(stamp)
        os.replace(stamp_tmp, _STAMP)
        return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded library (built first where needed), every function of the
    header typed by `SIGNATURES`. Raises `BuildError`."""
    global _loaded
    path = build()
    with _lock:
        if _loaded is None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise BuildError(f"{path} did not load: {e}") from e
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _loaded = lib
        return _loaded


def build_program(source, out, include_dir=None) -> Path:
    """Compile a C (``.c``) or C++ program over the library into ``out``,
    linked to ``libusearch_torch.so`` and libpython (rpaths to both), its
    includes from ``include_dir`` (default: this directory, the port's
    header). Raises `BuildError`, also when the interpreter has no shared
    libpython, without which no standalone program can start one."""
    link = python_link()
    if link is None:
        raise BuildError("this Python has no shared libpython: a standalone program over the C ABI cannot be linked")
    source, out = Path(source), Path(out)
    compiler = ["cc", "-O2", "-Wall"] if source.suffix == ".c" else ["g++", "-O2", "-std=c++17", "-Wall"]
    lib = build()
    _run([*compiler, f"-I{include_dir or SRC_DIR}", "-o", str(out), str(source), f"-L{lib.parent}",
          "-lusearch_torch", f"-Wl,-rpath,{lib.parent}", *link], f"the build of {source.name}")
    return out
