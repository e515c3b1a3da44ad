"""Host helpers in C++: the key map (keymap.cc) and the ingestion casts
(casts.cc), loaded with ``ctypes``.

Each source is compiled by ``g++`` at first use into
``usearch_torch/_build/`` (not tracked by git), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. Callers fall back to their torch and Python versions when the build
or the load fails (no compiler); `keymap.NATIVE` and `ops.casts.NATIVE` say
which route loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

from ..build import BUILD_DIR

_SRC = Path(__file__).resolve().parent
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

class BuildError(RuntimeError):
    """A host library that did not build (no g++, a failed compile) or did
    not load."""


_lock = threading.Lock()
#: per source: the loaded library, or the error that stopped it
_loaded: Dict[str, Tuple[object, object]] = {}


def _target(name: str, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256((_SRC / f"{name}.cc").read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def library(name: str, signatures: Dict[str, tuple], flags: Sequence[str] = (),
            libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cc`` built with ``g++`` and
    the extra ``flags`` (``libs`` link after the source), its functions
    typed by ``signatures`` (name -> (argtypes, restype)); built at the
    first call of the process that needs it. Raises what the build or the
    load raised, as `BuildError`, at every call."""
    with _lock:
        lib, err = _loaded.get(name, (None, None))
        if lib is None and err is None:
            all_flags = [*_FLAGS, *flags]
            path = _target(name, [*all_flags, *libs])
            try:
                if not path.exists():
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = path.with_suffix(f".{os.getpid()}.tmp")
                    subprocess.run(["g++", *all_flags, "-o", str(tmp), str(_SRC / f"{name}.cc"), *libs],
                                   check=True, capture_output=True)
                    os.replace(tmp, path)
                lib = ctypes.CDLL(str(path))
                for fn, (argtypes, restype) in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
            except (OSError, subprocess.CalledProcessError) as e:
                err = BuildError(f"native/{name}.cc did not build or load: {e}")
            _loaded[name] = (lib, err)
        if err is not None:
            raise err
        return lib
