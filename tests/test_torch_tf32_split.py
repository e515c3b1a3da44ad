"""The three-pass TF32 product of the f32 probe and flat-scan kernels
(csrc/wgmma_common.cuh `split_tf32`, `mma_tf32x3`) through its plain twin
`usearch_torch.ops.tf32`:

- the twin's split and dots against exact (f64) products over random
  exponents, signs, zeros, subnormals and widths 32-1,024, within the bound
  the twin states (`PRODUCT_RTOL` a product, `dot_bound` a dot);
- the twin is the kernels' arithmetic: the same rounding on the bits and
  the same term order in the source;
- B3/B5 (grouped probe) and B8/B9/B10 (flat-scan flavours) over f32, with
  the plain versions' dots taken by the twin, against the JAX package's
  Pallas kernels in interpret mode within the tolerance chip_smoke.py holds
  the kernels to on the card, and that tolerance covers the product's
  bound."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops import pallas_scan as jscan  # noqa: E402
from usearch_tpu.ops.distances import row_stats as j_row_stats  # noqa: E402
from usearch_tpu.ops.pallas_probe import (pallas_ivf_probe_grouped,  # noqa: E402
                                          pallas_ivf_probe_grouped_nofold)

import chip_smoke  # noqa: E402
from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import probe, scan, tf32  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "usearch_torch" / "csrc"


def operands(seed: int, n: int, e_lo: int, e_span: int, zeros: float, subnormals: float) -> np.ndarray:
    """``n`` f32 values: random signs and mantissas, exponents in [e_lo,
    e_lo + e_span], a share of zeros and a share of subnormals."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1, 2, n) * np.exp2(rng.integers(e_lo, e_lo + e_span + 1, n)) * rng.choice([-1.0, 1.0], n)
    x = x.astype(np.float32)
    sub = rng.random(n) < subnormals
    x[sub] = (rng.integers(1, 2**23, int(sub.sum())) * 2.0**-149 * rng.choice([-1.0, 1.0], int(sub.sum())))
    x[rng.random(n) < zeros] = 0.0
    return x


CASES = dict(seed=st.integers(0, 2**32 - 1), width=st.integers(1, 32).map(lambda m: 32 * m),
             e_lo=st.integers(-140, 40), e_span=st.integers(0, 20), zeros=st.sampled_from([0.0, 0.1, 0.5]),
             subnormals=st.sampled_from([0.0, 0.05, 0.5]))


@settings(max_examples=60, deadline=None, database=None)
@given(**CASES)
def test_split_products_within_the_bound(seed, width, e_lo, e_span, zeros, subnormals):
    """Each product of the three halves against the exact product (both in
    f64, where a product of two TF32 values is exact)."""
    a = operands(seed, width, e_lo, e_span, zeros, subnormals)
    b = operands(seed + 1, width, e_lo, e_span, zeros, subnormals)
    (ah, al), (bh, bl) = (tf32.split(torch.from_numpy(x)) for x in (a, b))
    for half in (ah, al, bh, bl):  # TF32 values: the low 13 bits are zero
        assert not (half.view(torch.int32) & 0x1FFF).any()
    ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
    got = ah * bl + al * bh + ah * bh
    a64, b64 = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    bound = tf32.PRODUCT_RTOL * (a64 * b64).abs() + tf32.SUBNORMAL_ATOL * (a64.abs() + b64.abs())
    assert ((got - a64 * b64).abs() <= bound).all()


@settings(max_examples=40, deadline=None, database=None)
@given(**CASES)
def test_split_dots_within_the_bound(seed, width, e_lo, e_span, zeros, subnormals):
    """The twin's dots, k-step by k-step into an f32 accumulator, against
    exact dots, within `dot_bound`."""
    a = operands(seed, 2 * width, e_lo, e_span, zeros, subnormals).reshape(2, width)
    b = operands(seed + 7, 3 * width, e_lo, e_span, zeros, subnormals).reshape(3, width)
    got = tf32.dots(torch.from_numpy(a), torch.from_numpy(b)).double()
    exact = torch.tensor([[float(np.sum(np.float64(x) * np.float64(y), dtype=np.float64)) for y in b] for x in a],
                         dtype=torch.float64)
    assert torch.isfinite(got).all()
    assert ((got - exact).abs() <= tf32.dot_bound(torch.from_numpy(a), torch.from_numpy(b))).all()


def test_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0**-10
    x = torch.tensor([1.0, 1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2**-23, 3.0e38, 0.0, -0.0])
    want = [1.0, 1 + one_ulp, -(1 + one_ulp), 1.0, float(tf32.tf32_rna(torch.tensor([3.0e38])))]
    got = tf32.tf32_rna(x).tolist()
    assert got[:4] == want[:4] and got[5:] == [0.0, 0.0]
    assert abs(got[4] - 3.0e38) <= 2.0**-11 * 3.0e38


def test_twin_is_the_kernels_arithmetic():
    """The kernels round on the bits as the twin does, split both operands
    the same way and issue the cross terms before hi . hi, in the twin's
    order; both f32 kernels take that product."""
    header = (CSRC / "wgmma_common.cuh").read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in header
    assert "lo = tf32_rna(__fsub_rn(x, hi));" in header
    body = header[header.index("__device__ __forceinline__ void mma_tf32x3("):]
    calls = re.findall(r"mma_k\(d, (a_\w+), s, (b\w*), ", body[: body.index("}")])
    assert calls == [("a_hi", "b_lo"), ("a_lo", "b"), ("a_hi", "b")]
    assert re.search(r"m64n128k8\.f32\.tf32\.tf32", header) and re.search(r"m64n256k8\.f32\.tf32\.tf32", header)
    for source in ("probe.cu", "fused.cu"):
        text = (CSRC / source).read_text()
        assert "mma_tf32x3(acc, qh, ql," in text and "split_tile(buf," in text and "tf32_frags(buf +" in text


@pytest.mark.parametrize("width", [32, 128, 256, 1024])
def test_chip_smoke_tolerance_covers_the_bound(width):
    """chip_smoke.py holds the f32 kernels to FLOAT_RTOL and `tf32_atol`:
    FLOAT_ATOL and ``dot_rtol(W) + TERMS_ATOL`` times the largest q_sq +
    t_sq (2 for cos). A dot's error is at most `dot_bound`, ``dot_rtol(W)
    sum |q_i t_i|`` with ``sum |q_i t_i| <= (q_sq + t_sq) / 2``; l2sq's -2 dot
    doubles it, and the plain version's f32 sums in another order take
    TERMS_ATOL, as bf16's do."""
    rng = np.random.default_rng(width)
    q = torch.from_numpy(rng.standard_normal((4, width)).astype(np.float32))
    t = torch.from_numpy((3 * rng.standard_normal((9, width))).astype(np.float32))
    scale = float((q * q).sum(1).max() + (t * t).sum(1).max())
    bound = 2 * float(tf32.dot_bound(q, t).max())
    atol = chip_smoke.tf32_atol(MetricKind.L2sq, q, t)
    assert atol - chip_smoke.FLOAT_ATOL - chip_smoke.TERMS_ATOL * scale >= bound
    assert chip_smoke.tf32_atol(MetricKind.IP, q, t) == atol
    unit_q, unit_t = q / q.norm(dim=1, keepdim=True), t / t.norm(dim=1, keepdim=True)
    assert chip_smoke.tf32_atol(MetricKind.Cos, q, t) >= chip_smoke.FLOAT_ATOL + float(
        tf32.dot_bound(unit_q, unit_t).max())


def atol_for(metric: str, q: np.ndarray, t: np.ndarray) -> float:
    return chip_smoke.tf32_atol(MetricKind(metric), torch.from_numpy(q), torch.from_numpy(t))


def assert_within(got, want, atol: float):
    """Distances within chip_smoke's f32 tolerance; where ids differ, the
    port's candidate lies within it of a candidate the reference has."""
    (gd, gi), (wd, wi) = got, want
    assert gd.shape == wd.shape
    np.testing.assert_allclose(gd, wd, rtol=chip_smoke.FLOAT_RTOL, atol=atol)
    for row, col in zip(*np.nonzero(gi != wi)):
        near = np.abs(wd[row] - gd[row, col]) <= chip_smoke.FLOAT_RTOL * abs(gd[row, col]) + atol
        assert gi[row, col] in wi[row][near], (row, col)


@pytest.fixture
def twin_dots(monkeypatch):
    """The plain versions' f32 dots taken by the twin: what the kernels
    compute on the card."""

    def dots(q, t):
        return tf32.dots(q, t) if q.dtype == torch.float32 else plain_dot(q, t)

    plain_dot = scan.dot
    monkeypatch.setattr(scan, "dot", dots)
    monkeypatch.setattr(probe, "dot", dots)


N, W, G, W_PAD = 1024, 128, 128, 384


class Windows:
    """One cell of 128 pairs over an f32 table of N rows: a segment across
    the two warpgroups (lanes 50-80), windows mid-bin, an empty one, one
    ending at the table's last row; ~10% deleted rows; planted copies of
    queries among the rows."""

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        spans = [(5, 250)] * 50 + [(300, 180)] * 31 + [(0, 0)] * 7 + [(N - 200, 200)] * 40
        self.st = np.array([s for s, _ in spans], np.int32)
        self.ln = np.array([n for _, n in spans], np.int32)
        self.t = rng.standard_normal((N, W)).astype(np.float32)
        self.q = rng.standard_normal((G, W)).astype(np.float32)
        self.t[10], self.t[400] = self.q[3], self.q[60]
        self.t_sq = (self.t * self.t).sum(axis=1, dtype=np.float32)
        self.q_sq = (self.q * self.q).sum(axis=1, dtype=np.float32)
        self.penalty = np.where(rng.random(N) >= 0.1, 0.0, MASKED).astype(np.float32)
        self.base = np.minimum(self.st // 128 * 128, N - W_PAD).astype(np.int32)
        self.meta = np.zeros((1, 8, G), np.int32)
        self.widx = np.full(G, -1, np.int32)
        seen = {}
        for pair in range(G):
            if self.ln[pair]:
                key = (int(self.st[pair]), int(self.ln[pair]))
                if key not in seen:
                    seen[key] = len(seen)
                    self.meta[0, :3, seen[key]] = (self.base[pair], self.st[pair] - self.base[pair], self.ln[pair])
                self.widx[pair] = seen[key]
        self.meta[0, 3, 0] = len(seen)

    def pallas_args(self, metric):
        t_aux = self.penalty[None, :] if metric == "ip" else np.stack(
            [self.t_sq, self.t.sum(axis=1), self.penalty, np.zeros_like(self.penalty)])
        q_aux = np.zeros((G, 8), np.float32)
        q_aux[:, 0], q_aux[:, 2] = self.q_sq, self.widx
        return (JMetric(metric), jnp.asarray(self.q), jnp.asarray(q_aux), jnp.asarray(self.t), jnp.asarray(t_aux),
                jnp.asarray(self.meta))

    def port_args(self, metric):
        f = torch.from_numpy
        return (MetricKind(metric), f(self.q), f(self.q_sq), f(self.t), None if metric == "ip" else f(self.t_sq),
                f(self.penalty))


@pytest.mark.parametrize("metric", ["ip", "cos", "l2sq"])
def test_grouped_probe_f32_matches_pallas(twin_dots, metric):
    lay = Windows()
    got = probe.grouped_probe(*lay.port_args(metric), torch.from_numpy(lay.st), torch.from_numpy(lay.ln), 10, 4)
    want = pallas_ivf_probe_grouped(*lay.pallas_args(metric), 10, W_PAD, G, 4, True, 2, 1, True)
    assert_within(tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want), atol_for(metric, lay.q, lay.t))
    assert (got[1].numpy()[lay.ln == 0] == -1).all() and (got[1].numpy()[lay.ln > 0, 0] >= 0).all()


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_grouped_probe_nofold_f32_matches_pallas(twin_dots, metric):
    lay = Windows(1)
    f = torch.from_numpy
    got = probe.grouped_probe_nofold(*lay.port_args(metric), f(lay.base), f(lay.st), f(lay.ln), W_PAD, 8)
    want = pallas_ivf_probe_grouped_nofold(*lay.pallas_args(metric), W_PAD, G, 8, True)
    assert_within(tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want), atol_for(metric, lay.q, lay.t))


class Flat:
    """An f32 table of 16 bins with bin 3 a noisy copy of the queries and
    ~10% deleted rows, and 32 queries, in both packages."""

    def __init__(self, seed: int = 0, n: int = 2048, nq: int = 32):
        rng = np.random.default_rng(seed)
        self.t = rng.standard_normal((n, W)).astype(np.float32)
        self.q = rng.standard_normal((nq, W)).astype(np.float32)
        self.t[384 : 384 + nq] = self.q + 0.01 * rng.standard_normal((nq, W)).astype(np.float32)
        self.valid = rng.random(n) >= 0.1
        self.stats = np.array(j_row_stats(jnp.asarray(self.t), usearch_tpu.ScalarKind.F32))

    def jax_args(self, metric, k):
        return (JMetric(metric), jnp.asarray(self.q), jnp.asarray(self.t), jnp.asarray(self.stats),
                jnp.asarray(self.valid), k)

    def port_args(self, metric):
        return MetricKind(metric), torch.from_numpy(self.q), torch.from_numpy(self.t), torch.from_numpy(
            self.stats), torch.from_numpy(self.valid)


@pytest.mark.parametrize("metric", ["ip", "cos", "l2sq"])
def test_fused_searches_f32_match_pallas(twin_dots, metric):
    """B8, B9 and B10's searches, with the kernels' dots, against
    `pallas_search`, `pallas_search_dma` and `pallas_search_binned`; B8 and
    B9 give B10's distances."""
    data = Flat()
    atol = atol_for(metric, data.q, data.t)
    args = data.port_args(metric)
    b8, b9, b10 = (tuple(x.numpy() for x in fn(*args, 10)) for fn in (
        scan.search_fused, scan.search_fused_stream, scan.search_binned_lanes))
    want8 = jscan.pallas_search(*data.jax_args(metric, 10), q_tile=32, t_tile=512, interpret=True)
    want9 = jscan.pallas_search_dma(*data.jax_args(metric, 10), q_tile=32, t_tile=512, merge_every=2,
                                    interpret=True)
    want10 = jscan.pallas_search_binned(*data.jax_args(metric, 10), q_tile=32, t_tile=512, interpret=True)
    for got, want in ((b8, want8), (b9, want9), (b10, want10)):
        assert_within(got, tuple(np.asarray(x) for x in want), atol)
    np.testing.assert_array_equal(b8[0], b10[0])
    np.testing.assert_array_equal(b9[0], b10[0])
