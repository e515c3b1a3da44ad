"""The three-pass TF32 product of the f32 probe and flat-scan kernels, in
plain torch: the twin of csrc/wgmma_common.cuh's `tf32_rna`, `split_tf32`
and `mma_tf32x3`, for the tests and chip_smoke.py; no search calls it.

B3/B5/B6's lists and B8-B10 over f32 rows multiply on the tensor cores in
TF32 (1 sign, 8 exponent and 10 mantissa bits). Each operand is split into
``x = hi + lo``, ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (``x - hi`` is
exact in f32), each rounded to the nearest TF32 value with ties away from
zero, on the bits. A dot is taken one `wgmma` k-step (``K_STEP`` columns)
at a time as ``a_hi . b_lo``, then ``a_lo . b_hi``, then ``a_hi . b_hi``,
each added to an f32 accumulator; ``a_lo . b_lo`` is dropped.

Each product ``a b`` is then within ``PRODUCT_RTOL |a b| + SUBNORMAL_ATOL
(|a| + |b|)`` of the exact one: with ``|x - hi| <= 2^-11 |x|`` and ``|lo -
tf32(lo)| <= 2^-11 |lo|`` for normal values, the error ``a_hi (b_lo -
tf32(b_lo)) + (a_lo - tf32(a_lo)) b_hi + a_lo b_lo`` is at most ``2^-22 (3
+ 2^-10) |a b|``; a half below f32's normal range rounds on a grid of
2^-136, which adds at most 2^-136 times the other operand to each term.
`dot_bound` adds the accumulator's roundings to that.
"""

from __future__ import annotations

import torch

#: columns of one `wgmma` k-step of f32 (32 bytes)
K_STEP = 8
#: a product's error from the split, relative to ``|a b|``: 2^-22 (3 +
#: 2^-10), with room for the terms below 2^-33 |a b|
PRODUCT_RTOL = 2.0**-22 * 3.001
#: a product's error from halves below f32's normal range, per unit of
#: ``|a| + |b|``
SUBNORMAL_ATOL = 2.0**-135
#: one rounding of an f32 accumulator: relative, and absolute below the
#: normal range
ADD_RTOL, ADD_ATOL = 2.0**-24, 2.0**-150


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest TF32 value, ties away from zero, as f32:
    the kernels' ``(bits + 0x1000) & 0xffffe000``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32(x)``, ``lo = tf32(x - hi)``."""
    x = x.float()
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[m, W] x [n, W] -> [m, n]`` f32 dots as the kernels' tensor cores
    take them: per k-step the three products of the split halves, each
    summed exactly (f64) and added to the f32 accumulator in the kernels'
    order. ``W`` need not be a multiple of ``K_STEP``."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
    for s in range(0, a.shape[1], K_STEP):
        cols = slice(s, s + K_STEP)
        for x, y in ((a_hi, b_lo), (a_lo, b_hi), (a_hi, b_hi)):
            acc = (acc.double() + x[:, cols].double() @ y[:, cols].double().T).float()
    return acc


def dot_rtol(width: int) -> float:
    """How far a dot of ``width`` columns may lie from the exact one, per
    unit of ``sum |a_i b_i|``: each product's split error, and one f32
    rounding of the accumulator per k-step and pass, each at most the sum
    of the terms' magnitudes (1 + 2 PRODUCT_RTOL)."""
    return PRODUCT_RTOL + 3 * -(-width // K_STEP) * ADD_RTOL * (1 + 2 * PRODUCT_RTOL)


def dot_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[m, n]``: how far `dots` may lie from the exact dots: `dot_rtol`
    times ``sum |a_i b_i|``, and the terms of halves below f32's normal
    range."""
    a, b = a.double().abs(), b.double().abs()
    adds = 3 * -(-a.shape[1] // K_STEP)
    spread = SUBNORMAL_ATOL * (a.sum(1)[:, None] + b.sum(1)[None, :])
    return dot_rtol(a.shape[1]) * (a @ b.T) + spread + adds * ADD_ATOL
