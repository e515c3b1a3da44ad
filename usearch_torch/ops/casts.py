"""Ingestion casts between scalar kinds, on tensors.

Counterpart of `usearch_tpu/ops/casts.py`, with the same semantics:

- float to float: a plain numeric cast (round to nearest even);
- float to i8: scale each row to unit L2 norm, then to +-127, clamp and
  truncate toward zero;
- i8 to float: divide by 127;
- anything to b1: bit = value > 0, packed MSB-first; uint8 input is
  already packed (the b1x8 convention);
- b1 to anything: set bits to 1, clear bits to 0, then as from f32.

`cast_rows` serves rows on any device. Host batches (`cast_vectors`) take
the C++ casts of native/casts.cc where they load, as the JAX package's host
path does (bit for bit the same), for f32 to i8, i8 to f32 and the b1
packing; else `cast_rows` on a CPU tensor. ``casts.NATIVE`` says which
route loaded (reading it builds the library). The two routes may differ by
one i8 step in a few entries per ten million: the native cast sums the
norm in f64, `_i8_quantize` in f32 and takes its root in f64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..enums import ScalarKind, to_torch_dtype
from .packbits import pack_bits, unpack_bits


def _i8_quantize(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize each row, scale to +-127, clamp, truncate. The norm is
    taken on max-rescaled rows, so ``x * x`` cannot overflow f32."""
    x = x.float()
    mx = x.abs().amax(dim=-1, keepdim=True)
    mx = torch.where(mx == 0.0, 1.0, mx)
    xn = x / mx
    norm = torch.sqrt((xn * xn).sum(dim=-1, keepdim=True).double()).float()  # correctly rounded
    norm = torch.where(norm == 0.0, 1.0, norm)
    s = torch.clamp(xn * (127.0 / norm), -127.0, 127.0)
    return torch.trunc(s).to(torch.int8)


def decode_i8(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 127.0


def as_tensor(values) -> torch.Tensor:
    """A numpy batch as a CPU tensor (no copy where the layout allows).
    bf16 arrays from other libraries are reinterpreted bit for bit."""
    values = np.ascontiguousarray(values)
    if not values.flags.writeable:  # torch tensors over read-only memory are unsafe
        values = values.copy()
    if values.dtype.name == "bfloat16":
        return torch.from_numpy(values.view(np.int16)).view(torch.bfloat16)
    if values.dtype.kind in "iu" and values.dtype not in (np.int8, np.uint8):
        values = values.astype(np.float32)
    return torch.from_numpy(values)


def cast_rows(x: torch.Tensor, from_kind: ScalarKind, to_kind: ScalarKind,
              ndim: Optional[int] = None) -> torch.Tensor:
    """Cast rows on whatever device they lie on. Packed b1 rows unpack to
    ``ndim`` columns (all ``8 B`` when None)."""
    if from_kind == to_kind:
        return x.to(to_torch_dtype(to_kind))
    if from_kind == ScalarKind.B1:
        decoded = unpack_bits(x.to(torch.uint8))[..., :ndim].float()
    elif from_kind == ScalarKind.I8:
        decoded = decode_i8(x)
    else:
        decoded = x.float()
    if to_kind == ScalarKind.B1:
        return pack_bits(decoded)
    if to_kind == ScalarKind.I8:
        return _i8_quantize(decoded)
    return decoded.to(to_torch_dtype(to_kind))


def _native():
    """The native casts' module, or None when their library does not build
    or load (no g++)."""
    from ..native import BuildError, casts_native

    try:
        casts_native.lib()
    except BuildError:
        return None
    return casts_native


def cast_vectors(values, from_kind: ScalarKind, to_kind: ScalarKind, ndim: Optional[int] = None) -> torch.Tensor:
    """Cast a host ``[B, ndim]`` batch (packed bytes for b1); the result is
    a CPU tensor."""
    native = None if from_kind in (to_kind, ScalarKind.B1) else _native()
    if native is None:
        return cast_rows(as_tensor(values), from_kind, to_kind, ndim)
    if from_kind == ScalarKind.I8:
        decoded = native.cast_i8_to_f32(values)
    else:  # no copy for f32 input
        decoded = cast_rows(as_tensor(values), from_kind, ScalarKind.F32).numpy()
    if to_kind == ScalarKind.I8:
        return torch.from_numpy(native.cast_f32_to_i8(decoded))
    if to_kind == ScalarKind.B1:
        return torch.from_numpy(native.pack_bits_f32(decoded, (decoded.shape[-1] + 7) // 8))
    return torch.from_numpy(decoded).to(to_torch_dtype(to_kind))


def __getattr__(name: str):
    if name == "NATIVE":
        return _native() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
