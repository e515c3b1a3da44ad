"""Kernels B1/B2 (their plain versions, on the CPU) against the TPU kernels
run in Pallas interpret mode, and the searches built on them against the
JAX package's.

Raw bin surfaces: i8 equal bit for bit; float minima within rtol 1e-5 (f32
sums in another order), their rows equal wherever a bin's two best rows are
further apart than that; compact bf16 minima equal or 1 bf16 ulp apart.
The port's surfaces are [Q, N/128], the TPU kernels' [N/128, Q]."""

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

import usearch_torch  # noqa: E402
from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.exact import kernel_tiles  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402
from usearch_torch.ops.distances import dot, scan_epilogue  # noqa: E402

METRICS = ["ip", "cos", "l2sq"]
DTYPES = ["i8", "bf16", "f32"]
_JAX = {"i8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}
_TORCH = {"i8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
RTOL = 1e-5


class Case:
    """One table and query batch in both frameworks, with ~10% deleted
    rows, zero rows and a zero query (cos's zero-norm rules)."""

    def __init__(self, dtype, n=2048, nq=64, w=128, seed=0, zeros=True):
        rng = np.random.default_rng(seed)
        if dtype == "i8":
            t = rng.integers(-127, 128, (n, w)).astype(np.int8)
            q = rng.integers(-127, 128, (nq, w)).astype(np.int8)
        else:
            t = rng.standard_normal((n, w)).astype(np.float32)
            q = rng.standard_normal((nq, w)).astype(np.float32)
        if zeros:
            t[:3] = 0
            q[0] = 0
        self.valid = rng.random(n) >= 0.1
        self.jt, self.jq = jnp.asarray(t, _JAX[dtype]), jnp.asarray(q, _JAX[dtype])
        self.tt, self.tq = torch.from_numpy(t).to(_TORCH[dtype]), torch.from_numpy(q).to(_TORCH[dtype])
        self.stats = np.array(j_row_stats(self.jt, usearch_tpu.ScalarKind(dtype)))
        qf = np.asarray(self.jq.astype(jnp.float32))
        self.q_sq = (qf * qf).sum(axis=1, dtype=np.float32)  # one q_sq for both
        self.penalty = np.where(self.valid, 0.0, jscan.MASKED).astype(np.float32)

    def torch_aux(self, metric):
        t_sq = None if metric == "ip" else torch.from_numpy(self.stats[:, 0].copy())
        return (MetricKind(metric), self.tq, self.tt, torch.from_numpy(self.q_sq), t_sq,
                torch.from_numpy(self.penalty))

    def pallas(self, metric, t_tile=512, q_tile=64, compact=False, minima=False):
        """The TPU kernel through pl.pallas_call in interpret mode, with the
        BlockSpecs of pallas_search_binned / pallas_search_exact."""
        n, w = self.jt.shape
        nq = self.jq.shape[0]
        if metric == "ip":
            t_aux = jnp.asarray(self.penalty)[None, :]
        else:
            s = self.stats
            t_aux = jnp.asarray(np.stack([s[:, 0], s[:, 1], self.penalty, np.zeros_like(self.penalty)]))
        q_aux = jnp.asarray(np.stack([self.q_sq, np.zeros_like(self.q_sq)]))
        n_bins = t_tile // 128
        in_specs = [
            pl.BlockSpec((q_tile, w), lambda qi, ti: (qi, 0)),
            pl.BlockSpec((2, q_tile), lambda qi, ti: (0, qi)),
            pl.BlockSpec((t_tile, w), lambda qi, ti: (ti, 0)),
            pl.BlockSpec((t_aux.shape[0], t_tile), lambda qi, ti: (0, ti)),
        ]
        out_spec = pl.BlockSpec((n_bins, q_tile), lambda qi, ti: (ti, qi))
        if minima:
            kernel = jscan._make_binned_t_min_kernel(JMetric(metric), t_tile)
            out_specs, out_shape = out_spec, jax.ShapeDtypeStruct((n // 128, nq), jnp.float32)
        else:
            kernel = jscan._make_binned_t_kernel(JMetric(metric), t_tile, compact, compact)
            out_specs = [out_spec, out_spec]
            out_shape = [jax.ShapeDtypeStruct((n // 128, nq), jnp.bfloat16 if compact else jnp.float32),
                         jax.ShapeDtypeStruct((n // 128, nq), jnp.int8 if compact else jnp.int32)]
        out = pl.pallas_call(kernel, grid=(nq // q_tile, n // t_tile), in_specs=in_specs,
                             out_specs=out_specs, out_shape=out_shape, interpret=True)(
            self.jq, q_aux, self.jt, t_aux)
        return np.asarray(out).T if minima else tuple(np.asarray(o).T for o in out)

    def clear_bins(self, metric, shifted, round_bf16, minima):
        """Bins whose two best rows are further apart than the tolerance."""
        m, q, t, q_sq, t_sq, pen = self.torch_aux(metric)
        if round_bf16:
            q, t = q.to(torch.bfloat16), t.to(torch.bfloat16)
        d = scan_epilogue(m, dot(q, t), q_sq, t_sq, pen, shifted)
        two = torch.topk(d.view(q.shape[0], -1, 128), 2, dim=-1, largest=False).values.numpy()
        tol = 1e-6 if round_bf16 else RTOL * np.abs(minima) + 1e-6
        return two[..., 1] - two[..., 0] > tol


def bf16_ulps(a, b):
    def ordered(x):
        bits = x.view(np.int16).astype(np.int32)
        return np.where(bits >= 0, bits, -(bits & 0x7FFF))

    return np.abs(ordered(a) - ordered(b))


SURFACES = [(d, m, False) for d in DTYPES for m in METRICS] + [("f32", m, True) for m in METRICS]


@pytest.mark.parametrize("dtype,metric,compact", SURFACES)
def test_binned_scan_surface(dtype, metric, compact):
    c = Case(dtype)
    want_v, want_i = c.pallas(metric, compact=compact)
    got_v, got_i = scan.binned_scan(*c.torch_aux(metric), compact=compact)
    if compact:
        got_v = got_v.view(torch.int16).numpy().view(want_v.dtype)
        assert bf16_ulps(got_v, want_v).max() <= 1
        clear = c.clear_bins(metric, True, True, None)
        np.testing.assert_array_equal(got_i.numpy()[clear], want_i[clear])
    elif dtype == "i8":
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
    else:
        np.testing.assert_allclose(got_v.numpy(), want_v, rtol=RTOL, atol=1e-6)
        clear = c.clear_bins(metric, False, False, want_v)
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got_i.numpy()[clear], want_i[clear])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_binned_minima_surface(dtype, metric):
    c = Case(dtype)
    want = c.pallas(metric, minima=True)
    got = scan.binned_minima(*c.torch_aux(metric)).numpy()
    if dtype == "i8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_kernel_gate_matches_reference():
    """The same calls reach the kernels in both packages."""
    for n in (1024, 1536, 4096, 6144, 131072, 1 << 20):
        for nq in (8, 64, 512, 1024):
            for k, approx in ((10, True), (129, True), (32, False), (33, False)):
                for kind in ("i8", "bf16", "f32", "f16"):
                    want = jscan.supports(JMetric.IP, usearch_tpu.ScalarKind(kind)) and \
                        usearch_tpu.exact._pallas_tiles(JMetric.IP, usearch_tpu.ScalarKind(kind),
                                                       np.zeros((nq, 1)), np.zeros((n, 1)), k, None, approx)
                    got = kernel_tiles(MetricKind.IP, ScalarKind(kind), nq, n, k, approx)
                    assert (got or None) == (want or None), (n, nq, k, approx, kind)


def sorted_results(d, i):
    d, i = np.asarray(d), np.asarray(i)
    order = np.lexsort((i, d), axis=1)
    return np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1)


def assert_same_apart_from_ties(got, want, exact: bool, atol: float = 1e-6):
    gd, gi = sorted_results(*got)
    wd, wi = sorted_results(*want)
    if exact:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=atol)
    differ = gi != wi
    # a different id only where its distance ties with the reference's
    np.testing.assert_allclose(gd[differ], wd[differ], rtol=RTOL, atol=atol)


@pytest.mark.parametrize("dtype", ["i8", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_binned_matches_reference(dtype, metric):
    c = Case(dtype, n=16384, nq=32, zeros=False)
    q_tile, t_tile = kernel_tiles(MetricKind(metric), ScalarKind(dtype), 32, 16384, 10, True)
    want = jscan.pallas_search_binned(JMetric(metric), c.jq, c.jt, c.stats, jnp.asarray(c.valid), 10,
                                      q_tile=q_tile, t_tile=t_tile, interpret=True, transposed=True)
    got = scan.search_binned(MetricKind(metric), c.tq, c.tt, torch.from_numpy(c.stats),
                             torch.from_numpy(c.valid), 10)
    assert_same_apart_from_ties(got, want, exact=dtype == "i8")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_search_exact_matches_reference(dtype, metric):
    c = Case(dtype, n=16384, nq=32, zeros=False)
    q_tile, t_tile = kernel_tiles(MetricKind(metric), ScalarKind(dtype), 32, 16384, 10, False)
    want = jscan.pallas_search_exact(JMetric(metric), c.jq, c.jt, c.stats, jnp.asarray(c.valid), 10,
                                     q_tile=q_tile, t_tile=t_tile, interpret=True)
    got = scan.search_exact(MetricKind(metric), c.tq, c.tt, torch.from_numpy(c.stats),
                            torch.from_numpy(c.valid), 10)
    assert_same_apart_from_ties(got, want, exact=dtype == "i8")


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_matches_reference(dtype, metric):
    """The public `exact_search` of both packages on the same rows: 3,000
    rows pad to 3,072, where the port takes kernel B2."""
    rng = np.random.default_rng(7)
    if dtype == "i8":
        data = rng.integers(-127, 128, (3000, 96)).astype(np.int8)
    else:
        data = rng.standard_normal((3000, 96)).astype(np.float32)
    queries = data[rng.choice(3000, 20, replace=False)]
    want = usearch_tpu.exact_search(data, queries, 10, metric=metric)
    got = usearch_torch.exact_search(data, queries, 10, metric=metric, device="cpu")
    # l2sq = |q|^2 + |t|^2 - 2 q.t cancels: its f32 error scales with the
    # squared norms (~100 here), not with the distance
    atol = RTOL * float((data.astype(np.float32) ** 2).sum(1).max()) if metric == "l2sq" else 1e-6
    assert_same_apart_from_ties((got.distances, got.keys.astype(np.int64)),
                                (want.distances, want.keys.astype(np.int64)), exact=dtype == "i8", atol=atol)
    np.testing.assert_array_equal(got.counts, want.counts)


def recall_at(ids, truth):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, truth)])


@pytest.mark.parametrize("metric", METRICS)
def test_compact_recall_not_below_reference(metric):
    """f32 storage: bf16 compact candidates + an exact rescore of 2k. The
    candidate sets may differ on bf16 ties, so the port is held to the
    reference's recall@10 against the exact answer, less 0.005."""
    c = Case("f32", n=32768, nq=64, zeros=False, seed=3)
    stats, valid = torch.from_numpy(c.stats), torch.from_numpy(c.valid)
    truth = scan.search_exact(MetricKind(metric), c.tq, c.tt, stats, valid, 10)[1].numpy()
    q_tile, t_tile = kernel_tiles(MetricKind(metric), ScalarKind.F32, 64, 32768, 10, True)
    want = jscan.pallas_search_binned(JMetric(metric), c.jq, c.jt, c.stats, jnp.asarray(c.valid), 10,
                                      q_tile=q_tile, t_tile=t_tile, interpret=True, transposed=True,
                                      compute_bf16=True, compact=True, oversample=scan.OVERSAMPLE)
    got = scan.search_binned(MetricKind(metric), c.tq, c.tt, stats, valid, 10, compact=True)
    r_port, r_ref = recall_at(got[1].numpy(), truth), recall_at(np.asarray(want[1]), truth)
    assert r_port >= r_ref - 0.005, (r_port, r_ref)
    # distances are exact f32 rescores on both sides
    gd, gi = got[0].numpy(), got[1].numpy()
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    for row in range(gi.shape[0]):
        common, a, b = np.intersect1d(gi[row], wi[row], return_indices=True)
        np.testing.assert_allclose(gd[row, a], wd[row, b], rtol=RTOL, atol=1e-6)
