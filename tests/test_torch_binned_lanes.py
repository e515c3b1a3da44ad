"""Kernel B10 (its plain version, on the CPU) against the TPU kernel
`_make_binned_kernel` run in Pallas interpret mode with the BlockSpecs of
`pallas_search_binned(transposed=False)`, with and without `split_dot` (one
result, so the port takes no such flag), and `search_binned_lanes` against
that JAX wrapper.

Surfaces are ``[N/128, Q]`` on both sides. i8: equal bit for bit (values
from [-3, 3], so bins tie everywhere). Floats: minima within rtol 1e-5 (atol
1e-6; f32 sums in another order), rows equal wherever a bin's two best rows
are further apart than that."""

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
RTOL, ATOL = 1e-5, 1e-6


class Data:
    """A table and query batch in both frameworks: ~10% deleted rows, a
    fully deleted 512-row stretch, and (``zeros``) zero rows and a zero
    query; i8 values from [-3, 3] unless ``wide``."""

    def __init__(self, dtype, n=2048, nq=64, w=128, seed=0, zeros=True, wide=False):
        rng = np.random.default_rng(seed)
        if dtype == "i8":
            hi = 127 if wide else 3
            t = rng.integers(-hi, hi + 1, (n, w)).astype(np.int8)
            q = rng.integers(-hi, hi + 1, (nq, w)).astype(np.int8)
        else:
            t = rng.standard_normal((n, w)).astype(np.float32)
            q = rng.standard_normal((nq, w)).astype(np.float32)
        if zeros:
            t[:3] = 0
            q[0] = 0
        self.valid = rng.random(n) >= 0.1
        self.valid[512:1024] = False
        self.jt, self.jq = jnp.asarray(t, _JAX[dtype]), jnp.asarray(q, _JAX[dtype])
        self.tt, self.tq = torch.from_numpy(t).to(_TORCH[dtype]), torch.from_numpy(q).to(_TORCH[dtype])
        self.stats = np.array(j_row_stats(self.jt, usearch_tpu.ScalarKind(dtype)))
        qf = np.asarray(self.jq.astype(jnp.float32))
        self.q_sq = (qf * qf).sum(axis=1, dtype=np.float32)  # one q_sq for both
        self.penalty = np.where(self.valid, 0.0, jscan.MASKED).astype(np.float32)

    def torch_args(self, metric):
        t_sq = None if metric == "ip" else torch.from_numpy(self.stats[:, 0].copy())
        return (MetricKind(metric), self.tq, self.tt, torch.from_numpy(self.q_sq), t_sq,
                torch.from_numpy(self.penalty))

    def pallas(self, metric, split_dot, t_tile=512, q_tile=64):
        """`_make_binned_kernel` through pl.pallas_call in interpret mode,
        with the BlockSpecs of pallas_search_binned(transposed=False)."""
        n, w = self.jt.shape
        nq = self.jq.shape[0]
        s = self.stats
        t_aux = jnp.asarray(np.stack([s[:, 0], s[:, 1], self.penalty, np.zeros_like(self.penalty)]))
        q_aux = jnp.asarray(np.stack([self.q_sq, np.zeros_like(self.q_sq)]))
        out_spec = pl.BlockSpec((t_tile // 128, q_tile), lambda qi, ti: (ti, qi))
        out = pl.pallas_call(
            jscan._make_binned_kernel(JMetric(metric), t_tile, split_dot),
            grid=(nq // q_tile, n // t_tile),
            in_specs=[
                pl.BlockSpec((q_tile, w), lambda qi, ti: (qi, 0)),
                pl.BlockSpec((2, q_tile), lambda qi, ti: (0, qi)),
                pl.BlockSpec((t_tile, w), lambda qi, ti: (ti, 0)),
                pl.BlockSpec((4, t_tile), lambda qi, ti: (0, ti)),
            ],
            out_specs=[out_spec, out_spec],
            out_shape=[jax.ShapeDtypeStruct((n // 128, nq), jnp.float32),
                       jax.ShapeDtypeStruct((n // 128, nq), jnp.int32)],
            interpret=True,
        )(self.jq, q_aux, self.jt, t_aux)
        return tuple(np.asarray(o) for o in out)

    def clear_bins(self, metric, minima):
        """``[N/128, Q]``: bins whose two best rows are further apart than
        the tolerance."""
        m, q, t, q_sq, t_sq, pen = self.torch_args(metric)
        d = scan_epilogue(m, dot(q, t), q_sq, t_sq, pen)
        two = torch.topk(d.view(q.shape[0], -1, 128), 2, dim=-1, largest=False).values.numpy()
        return (two[..., 1] - two[..., 0]).T > RTOL * np.abs(minima) + ATOL


@pytest.mark.parametrize("split_dot", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_lanes_surface_matches_pallas(metric, dtype, split_dot):
    data = Data(dtype)
    want_v, want_i = data.pallas(metric, split_dot)
    got_v, got_i = (x.numpy() for x in scan.binned_scan_lanes(*data.torch_args(metric)))
    assert got_v.shape == want_v.shape == (2048 // 128, 64)
    if dtype == "i8":
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_i, want_i)
    else:
        np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=ATOL)
        clear = data.clear_bins(metric, want_v)
        live = want_v < jscan.MASKED / 2
        assert clear[live].mean() > 0.9
        # a fully deleted bin ties at MASKED: its first row on both sides
        np.testing.assert_array_equal(got_i[clear | ~live], want_i[clear | ~live])


@pytest.mark.parametrize("dtype", DTYPES)
def test_lanes_surface_is_b1_surface_transposed(dtype):
    """B10's surface is B1's, in the other orientation."""
    args = Data(dtype, seed=1).torch_args("l2sq")
    lanes = scan.binned_scan_lanes_plain(*args)
    b1 = scan.binned_scan_plain(*args)
    assert all(x.is_contiguous() for x in lanes)
    assert torch.equal(lanes[0], b1[0].T) and torch.equal(lanes[1], b1[1].T)


def sorted_results(d, i):
    d, i = np.asarray(d), np.asarray(i)
    order = np.lexsort((i, d), axis=1)
    return np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_search_binned_lanes_matches_reference(dtype, metric):
    """Ids equal apart from equal-distance ties: the top-k over the surface
    is torch.topk here and lax.approx_min_k there."""
    data = Data(dtype, n=4096, nq=64, seed=2, zeros=False, wide=True)
    split_dot = metric == "cos"
    want = jscan.pallas_search_binned(JMetric(metric), data.jq, data.jt, data.stats, jnp.asarray(data.valid), 10,
                                      q_tile=64, t_tile=1024, interpret=True, split_dot=split_dot)
    got = scan.search_binned_lanes(MetricKind(metric), data.tq, data.tt, torch.from_numpy(data.stats),
                                   torch.from_numpy(data.valid), 10)
    gd, gi = sorted_results(got[0].numpy(), got[1].numpy())
    wd, wi = sorted_results(*want)
    if dtype == "i8":
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    differ = gi != wi
    np.testing.assert_allclose(gd[differ], wd[differ], rtol=RTOL, atol=ATOL)
    assert differ.mean() < 0.05


def test_lanes_wrapper_runs_the_plain_version_on_cpu_tensors():
    args = Data("bf16", n=1024, nq=8).torch_args("cos")
    before = scan.binned_scan_lanes.launches
    want = scan.binned_scan_lanes_plain(*args)
    got = scan.binned_scan_lanes(*args)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32 and got[0].shape == (8, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert scan.binned_scan_lanes.launches == before


def test_lanes_refusals():
    data = Data("i8", n=1024, nq=8)
    m, q, t, q_sq, t_sq, pen = data.torch_args("l2sq")
    with pytest.raises(TypeError):
        scan.binned_scan_lanes(m, q.half(), t.half(), q_sq, t_sq, pen)
    with pytest.raises(TypeError):
        scan.binned_scan_lanes(m, q.float(), t, q_sq, t_sq, pen)
    with pytest.raises(ValueError, match="multiples of 128"):
        scan.binned_scan_lanes(m, q, t[:1000], q_sq, t_sq[:1000], pen[:1000])
    with pytest.raises(ValueError, match="aux vectors"):
        scan.binned_scan_lanes(m, q, t, q_sq, None, pen)
    with pytest.raises(ValueError, match="ip/cos/l2sq"):
        scan.search_binned_lanes(MetricKind.Hamming, q, t, torch.from_numpy(data.stats),
                                 torch.from_numpy(data.valid), 10)
