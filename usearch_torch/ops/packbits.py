"""Bit packing for b1 (binary) rows, on the host and on tensors.

Counterpart of `usearch_tpu/ops/packbits.py`. Bits are MSB-first within
each byte: bit ``i`` of a vector lives at ``byte[i // 8] & (128 >> (i % 8))``,
as ``np.packbits(bitorder="big")`` packs them (USearch's b1x8 layout).

The binary metrics reduce to popcounts: with ``pop`` the set bits of a row
and ``and`` the set bits two rows share, hamming is ``pop_q + pop_t -
2 and``. `bit_dot` is that and-count, the plain version of the popcount
product inside kernel B3 (csrc/probe.cu, b1 instantiation).
"""

from __future__ import annotations

import numpy as np
import torch

#: shifts that take bit 7 (the first) down to bit 0 (the last) of a byte
_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)
#: the small constant tensors below, one copy a device: made at the first
#: use there, so a search captured as a CUDA graph (graphs.py) makes no
#: host-to-device copy while it is captured
_ON_DEVICE: dict = {}


def _on_device(name: str, values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    key = (name, torch.device(device))
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(values, dtype=dtype, device=device)
    return t


def pack_bits_np(values: np.ndarray) -> np.ndarray:
    """Pack the ``> 0`` truth values of a host array into uint8 bytes."""
    return np.packbits(np.asarray(values > 0, dtype=np.uint8), axis=-1, bitorder="big")


def unpack_bits_np(packed: np.ndarray, ndim: int) -> np.ndarray:
    """Packed uint8 bytes to a {0, 1} uint8 array of width ``ndim``."""
    return np.unpackbits(np.asarray(packed, dtype=np.uint8), axis=-1, bitorder="big")[..., :ndim]


def pack_bits(values: torch.Tensor) -> torch.Tensor:
    """Pack the ``> 0`` truth values of ``[..., D]`` into uint8 ``[...,
    ceil(D / 8)]``, on whatever device they lie on."""
    bits = (values > 0).to(torch.uint8)
    d = bits.shape[-1]
    if d % 8:
        bits = torch.nn.functional.pad(bits, (0, 8 - d % 8))
    bits = bits.reshape(*bits.shape[:-1], -1, 8)
    weights = _on_device("weights", [1 << s for s in _SHIFTS], torch.uint8, values.device)
    return (bits * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 ``[..., B]`` to int8 bits {0, 1} ``[..., 8 B]``."""
    shifts = _on_device("shifts", _SHIFTS, torch.uint8, packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(torch.int8)


#: set bits of every byte value
_POPCOUNT = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.int32)


def popcount_bytes(packed: torch.Tensor) -> torch.Tensor:
    """Set bits of each packed uint8 row ``[..., B]``, as int32 ``[...]``."""
    return _on_device("popcount", _POPCOUNT, torch.int32, packed.device)[packed.long()].sum(dim=-1, dtype=torch.int32)


def bit_dot(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """And-count of packed rows, ``[..., M, B] x [..., N, B] -> [..., M, N]``
    (leading dimensions broadcast as in ``torch.matmul``), as f32. The bits
    are multiplied as f32 0/1 values: while ``8 B <= 2**24`` every partial
    sum is an integer that f32 holds exactly, in TF32 too."""
    if q.shape[-1] * 8 > 1 << 24:
        raise ValueError(f"rows of {q.shape[-1]} bytes overflow the exact f32 and-count")
    return unpack_bits(q).float() @ unpack_bits(t).float().transpose(-1, -2)
