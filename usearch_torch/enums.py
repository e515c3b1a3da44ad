"""Metric and scalar kinds, their string normalizers, and the dtype maps.

The port's own copy of `usearch_tpu/enums.py`: the same names, aliases and
defaults, so both packages accept the same arguments. Storage dtypes map to
torch dtypes here; numpy has no bfloat16, so bf16 rows live only in tensors.
"""

from __future__ import annotations

import enum
from typing import Union

import numpy as np
import torch


class MetricKind(enum.Enum):
    Unknown = "unknown"
    IP = "ip"
    Cos = "cos"
    L2sq = "l2sq"
    Pearson = "pearson"
    Haversine = "haversine"
    Divergence = "divergence"
    Hamming = "hamming"
    Tanimoto = "tanimoto"
    Sorensen = "sorensen"
    Jaccard = "jaccard"


class ScalarKind(enum.Enum):
    Unknown = "unknown"
    F64 = "f64"
    F32 = "f32"
    F16 = "f16"
    BF16 = "bf16"
    I8 = "i8"
    B1 = "b1"


class MetricSignature(enum.Enum):
    ArrayArray = 0
    ArrayArraySize = 1
    ArrayArrayState = 2


class CompiledMetric:
    """A user-defined metric: ``fn(a[D], b[D]) -> distance`` on torch
    tensors (f32 rows of the stored width), applied to every pair with
    `torch.func.vmap`, so ``fn`` must be written in torch operations that
    vmap can batch. ``kind`` is the metric the IVF's partitions are ranked
    by (ip/cos/l2sq; any other kind ranks by l2sq)."""

    __slots__ = ("fn", "kind", "signature")

    def __init__(self, fn, kind: "MetricKind" = None, signature=None):
        if not callable(fn):
            raise TypeError("CompiledMetric needs a callable on torch tensors")
        self.fn = fn
        self.kind = kind if kind is not None else MetricKind.Unknown
        self.signature = signature or MetricSignature.ArrayArray

    @property
    def pointer(self):
        """The metric itself (the reference's name for the payload)."""
        return self.fn


MetricKindBitwise = (MetricKind.Hamming, MetricKind.Tanimoto, MetricKind.Sorensen)

#: Metrics scored from one dot product plus per-row stats.
MetricKindDot = (MetricKind.IP, MetricKind.Cos, MetricKind.L2sq, MetricKind.Pearson)

_METRIC_ALIASES = {
    "unknown": MetricKind.Unknown,
    "ip": MetricKind.IP,
    "dot": MetricKind.IP,
    "inner": MetricKind.IP,
    "inner_product": MetricKind.IP,
    "cos": MetricKind.Cos,
    "cosine": MetricKind.Cos,
    "angular": MetricKind.Cos,
    "l2sq": MetricKind.L2sq,
    "l2": MetricKind.L2sq,
    "euclidean": MetricKind.L2sq,
    "sqeuclidean": MetricKind.L2sq,
    "pearson": MetricKind.Pearson,
    "haversine": MetricKind.Haversine,
    "divergence": MetricKind.Divergence,
    "jensen_shannon": MetricKind.Divergence,
    "hamming": MetricKind.Hamming,
    "tanimoto": MetricKind.Tanimoto,
    "sorensen": MetricKind.Sorensen,
    "dice": MetricKind.Sorensen,
    "jaccard": MetricKind.Jaccard,
}

_DTYPE_ALIASES = {
    "f64": ScalarKind.F64,
    "float64": ScalarKind.F64,
    "f32": ScalarKind.F32,
    "float32": ScalarKind.F32,
    "f16": ScalarKind.F16,
    "float16": ScalarKind.F16,
    "bf16": ScalarKind.BF16,
    "bfloat16": ScalarKind.BF16,
    "i8": ScalarKind.I8,
    "int8": ScalarKind.I8,
    "b1": ScalarKind.B1,
    "b1x8": ScalarKind.B1,
    "bits": ScalarKind.B1,
}


def normalize_metric(metric: Union[str, MetricKind, None]) -> MetricKind:
    if metric is None:
        return MetricKind.Cos
    if isinstance(metric, MetricKind):
        return metric
    if isinstance(metric, str):
        key = metric.lower().strip()
        if key in _METRIC_ALIASES:
            return _METRIC_ALIASES[key]
    raise ValueError(f"Unknown metric: {metric!r}")


def normalize_dtype(
    dtype: Union[str, ScalarKind, np.dtype, torch.dtype, type, None],
    ndim: int = 0,
    metric: MetricKind = MetricKind.Cos,
) -> ScalarKind:
    """Resolve a storage dtype. Default: b1 for bitwise metrics, else bf16."""
    if dtype is None or dtype == "":
        return ScalarKind.B1 if metric in MetricKindBitwise else ScalarKind.BF16
    if isinstance(dtype, ScalarKind):
        return dtype
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        key = dtype.lower().strip()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"Unknown dtype: {dtype!r}")
    try:
        name = np.dtype(dtype).name
    except TypeError as exc:
        raise ValueError(f"Unknown dtype: {dtype!r}") from exc
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    if name == "bool":
        return ScalarKind.B1
    raise ValueError(f"Unknown dtype: {dtype!r}")


_TORCH_DTYPES = {
    ScalarKind.F64: torch.float64,
    ScalarKind.F32: torch.float32,
    ScalarKind.F16: torch.float16,
    ScalarKind.BF16: torch.bfloat16,
    ScalarKind.I8: torch.int8,
    ScalarKind.B1: torch.uint8,
}


def to_torch_dtype(kind: ScalarKind) -> torch.dtype:
    return _TORCH_DTYPES[kind]


def kind_of_dtype(dt) -> ScalarKind:
    """Scalar kind of user input, from a numpy or torch dtype."""
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return ScalarKind.BF16
        if dt == torch.uint8:
            return ScalarKind.B1
        if dt == torch.int8:
            return ScalarKind.I8
        if dt.is_floating_point:
            return {torch.float64: ScalarKind.F64, torch.float16: ScalarKind.F16}.get(
                dt, ScalarKind.F32
            )
        if dt == torch.bool or dt.is_complex:
            raise ValueError(f"Unsupported input dtype: {dt}")
        return ScalarKind.F32  # generic ints are read as floats
    dt = np.dtype(dt)
    if dt == np.uint8:
        return ScalarKind.B1  # packed bits (b1x8 convention)
    if dt == np.int8:
        return ScalarKind.I8
    if dt == np.float64:
        return ScalarKind.F64
    if dt == np.float16:
        return ScalarKind.F16
    if dt.name == "bfloat16":
        return ScalarKind.BF16
    if dt == np.float32:
        return ScalarKind.F32
    if np.issubdtype(dt, np.integer):
        return ScalarKind.F32  # generic ints are read as floats
    raise ValueError(f"Unsupported input dtype: {dt}")


DEFAULT_CONNECTIVITY = 16
DEFAULT_EXPANSION_ADD = 128
DEFAULT_EXPANSION_SEARCH = 64

USES_OPENMP = False
USES_SIMSIMD = False
USES_FP16LIB = False
