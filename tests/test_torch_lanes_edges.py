"""The edges of kernel B10 on the tensor-core kernel of csrc/fused.cu: its
plain version, which `binned_scan_lanes` runs for CPU tensors, against the
TPU kernel `_make_binned_kernel` in Pallas interpret mode, at the shapes of
chip_smoke.py's LANES_EDGES cut small.

Each table plants bins of equal minima: bin 1 holds the first queries, and
bins 2 (across the edge of a 256-row tile), 7 and 8 and the last bin are
copies of it, rows and deleted rows alike. Odd bin counts (a half last
256-row tile) and query counts that are no multiple of 64 or 128. The TPU
wrapper takes whole tiles only, so the JAX side runs one query block of
the batch and its table padded with one deleted bin to whole 256-row tiles;
only the real bins are compared.

Surfaces are ``[N/128, Q]`` on both sides. i8: equal bit for bit. bf16 and
f32: minima within rtol 1e-5 (atol 1e-6 times the largest q_sq + t_sq: f32
sums in another order, and l2sq cancels to near 0 on the planted copies of
the queries), rows equal wherever a bin's two best rows are further apart
than that; the planted bins' rows equal, each its bin's first row reaching
the minimum."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops import pallas_scan as jscan  # noqa: E402
from usearch_tpu.ops.distances import row_stats as j_row_stats  # noqa: E402

from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402
from usearch_torch.ops.distances import dot, scan_epilogue  # noqa: E402

METRICS = ["ip", "cos", "l2sq"]
DTYPES = ["i8", "bf16", "f32"]
_JAX = {"i8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}
_TORCH = {"i8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
RTOL, ATOL_REL = 1e-5, 1e-6
#: (bins, queries): odd bin counts, query counts no multiple of 64 or 128
SHAPES = [(19, 40), (9, 100)]
#: bins that copy bin 1: across a 256-row tile edge (1 | 2), and 7, 8
COPIES = (2, 7, 8)
W = 128
T_TILE = 256


class PlantedData:
    """``n_bins`` bins of width W and ``nq`` queries in both frameworks,
    ~10% deleted, rows 0-2 and query 0 zero; bin 1 holds the first queries
    (bf16 and f32: with noise), the bins of COPIES and the last bin copy
    it."""

    def __init__(self, dtype, n_bins, nq, seed=0):
        rng = np.random.default_rng(seed)
        n = n_bins * 128
        if dtype == "i8":
            t = rng.integers(-20, 21, (n, W)).astype(np.int8)
            q = rng.integers(-20, 21, (nq, W)).astype(np.int8)
            t[128 : 128 + min(nq, 128)] = q[:128]
        else:
            t = rng.standard_normal((n, W)).astype(np.float32)
            q = rng.standard_normal((nq, W)).astype(np.float32)
            m = min(nq, 128)
            t[128 : 128 + m] = q[:m] + 0.5 * rng.standard_normal((m, W)).astype(np.float32)
        q[0] = 0
        t[:3] = 0
        self.valid = rng.random(n) >= 0.1
        for b in COPIES + (n_bins - 1,):
            t[b * 128 : (b + 1) * 128] = t[128:256]
            self.valid[b * 128 : (b + 1) * 128] = self.valid[128:256]
        self.n_bins, self.nq = n_bins, nq
        self.jt, self.jq = jnp.asarray(t, _JAX[dtype]), jnp.asarray(q, _JAX[dtype])
        self.tt, self.tq = torch.from_numpy(t).to(_TORCH[dtype]), torch.from_numpy(q).to(_TORCH[dtype])
        self.stats = np.array(j_row_stats(self.jt, usearch_tpu.ScalarKind(dtype)))
        qf = np.asarray(self.jq.astype(jnp.float32))
        self.q_sq = (qf * qf).sum(axis=1, dtype=np.float32)  # one q_sq for both
        self.penalty = np.where(self.valid, 0.0, jscan.MASKED).astype(np.float32)
        self.atol = ATOL_REL * float(self.q_sq.max() + self.stats[:, 0].max())

    def torch_args(self, metric):
        t_sq = None if metric == "ip" else torch.from_numpy(self.stats[:, 0].copy())
        return (MetricKind(metric), self.tq, self.tt, torch.from_numpy(self.q_sq), t_sq,
                torch.from_numpy(self.penalty))

    def pallas(self, metric):
        """`_make_binned_kernel` through pl.pallas_call in interpret mode with
        the BlockSpecs of pallas_search_binned(transposed=False): the batch
        as one query block, the table padded to whole T_TILE tiles with
        deleted zero rows; the real bins of ``[N/128, Q]``."""
        n, w = self.jt.shape
        pad = -n % T_TILE
        table = jnp.concatenate([self.jt, jnp.zeros((pad, w), self.jt.dtype)])
        s = np.concatenate([self.stats, np.zeros((pad, 2), np.float32)])
        penalty = np.concatenate([self.penalty, np.full(pad, jscan.MASKED, np.float32)])
        t_aux = jnp.asarray(np.stack([s[:, 0], s[:, 1], penalty, np.zeros_like(penalty)]))
        q_aux = jnp.asarray(np.stack([self.q_sq, np.zeros_like(self.q_sq)]))
        nq = self.nq
        out_spec = pl.BlockSpec((T_TILE // 128, nq), lambda qi, ti: (ti, qi))
        out = pl.pallas_call(
            jscan._make_binned_kernel(JMetric(metric), T_TILE),
            grid=(1, (n + pad) // T_TILE),
            in_specs=[
                pl.BlockSpec((nq, w), lambda qi, ti: (qi, 0)),
                pl.BlockSpec((2, nq), lambda qi, ti: (0, qi)),
                pl.BlockSpec((T_TILE, w), lambda qi, ti: (ti, 0)),
                pl.BlockSpec((4, T_TILE), lambda qi, ti: (0, ti)),
            ],
            out_specs=[out_spec, out_spec],
            out_shape=[jax.ShapeDtypeStruct(((n + pad) // 128, nq), jnp.float32),
                       jax.ShapeDtypeStruct(((n + pad) // 128, nq), jnp.int32)],
            interpret=True,
        )(self.jq, q_aux, table, t_aux)
        return tuple(np.asarray(o)[: self.n_bins] for o in out)

    def clear_bins(self, metric, minima):
        """``[N/128, Q]``: bins whose two best rows are further apart than
        the tolerance."""
        m, q, t, q_sq, t_sq, pen = self.torch_args(metric)
        d = scan_epilogue(m, dot(q, t), q_sq, t_sq, pen)
        two = torch.topk(d.view(q.shape[0], -1, 128), 2, dim=-1, largest=False).values.numpy()
        return (two[..., 1] - two[..., 0]).T > RTOL * np.abs(minima) + self.atol


@pytest.mark.parametrize("n_bins,nq", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_lanes_edges_match_pallas(metric, dtype, n_bins, nq):
    data = PlantedData(dtype, n_bins, nq)
    want_v, want_i = data.pallas(metric)
    got_v, got_i = (x.numpy() for x in scan.binned_scan_lanes(*data.torch_args(metric)))
    assert got_v.shape == want_v.shape == (n_bins, nq) and got_i.dtype == np.int32
    planted = [1, *COPIES, n_bins - 1]
    if dtype == "i8":
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_i, want_i)
        # the planted bins tie across the tile edge: equal minima, each bin's own first row
        for b in planted[1:]:
            np.testing.assert_array_equal(got_v[b], got_v[1])
            np.testing.assert_array_equal(got_i[b] - b * 128, got_i[1] - 128)
        return
    np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=data.atol)
    clear = data.clear_bins(metric, want_v)
    live = want_v < jscan.MASKED / 2
    assert clear[live].mean() > 0.75  # most bins are decided: the comparison of rows is not empty
    # a fully deleted bin ties at MASKED: its first row on both sides
    np.testing.assert_array_equal(got_i[clear | ~live], want_i[clear | ~live])
    for b in planted[1:]:
        np.testing.assert_allclose(got_v[b], got_v[1], rtol=RTOL, atol=data.atol)
        sure = clear[b] & clear[1]
        np.testing.assert_array_equal(got_i[b][sure] - b * 128, got_i[1][sure] - 128)
