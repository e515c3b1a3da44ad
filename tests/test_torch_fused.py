"""Kernels B8/B9 (their plain version, on the CPU) and the fused searches
against the TPU kernels `pallas_search` and `pallas_search_dma` run in
Pallas interpret mode.

i8: equal bit for bit, ids, tie order and the ``(3e38, -1)`` padding
included. Floats: distances within rtol 1e-5 (atol 1e-6; f32 sums in
another order), ids equal wherever both neighbouring candidates are further
apart than that."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops import pallas_scan as jscan  # noqa: E402
from usearch_tpu.ops.distances import row_stats as j_row_stats  # noqa: E402

from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402

METRICS = ["ip", "cos", "l2sq"]
DTYPES = ["i8", "bf16", "f32"]
_JAX = {"i8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}
_TORCH = {"i8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
RTOL, ATOL = 1e-5, 1e-6


class Data:
    """One table and query batch in both frameworks: zero rows and a zero
    query (cos's zero-norm rules), ~10% deleted rows and a fully deleted
    512-row stretch; ``narrow`` i8 values from [-3, 3] tie everywhere;
    ``live_bins`` keeps only those 128-row bins live."""

    def __init__(self, dtype, n=2048, nq=64, w=128, seed=0, narrow=False, live_bins=None):
        rng = np.random.default_rng(seed)
        if dtype == "i8":
            hi = 3 if narrow else 127
            t = rng.integers(-hi, hi + 1, (n, w)).astype(np.int8)
            q = rng.integers(-hi, hi + 1, (nq, w)).astype(np.int8)
        else:
            t = rng.standard_normal((n, w)).astype(np.float32)
            q = rng.standard_normal((nq, w)).astype(np.float32)
        t[:3] = 0
        q[0] = 0
        self.valid = rng.random(n) >= 0.1
        self.valid[512:1024] = False
        if live_bins is not None:
            self.valid[:] = False
            for b in live_bins:
                self.valid[b * 128 : (b + 1) * 128] = True
        self.exact = dtype == "i8"
        self.jt, self.jq = jnp.asarray(t, _JAX[dtype]), jnp.asarray(q, _JAX[dtype])
        self.tt, self.tq = torch.from_numpy(t).to(_TORCH[dtype]), torch.from_numpy(q).to(_TORCH[dtype])
        self.stats = np.array(j_row_stats(self.jt, usearch_tpu.ScalarKind(dtype)))

    def pallas(self, metric, k, t_tile=512, merge_every=None):
        """`pallas_search` (or `pallas_search_dma` with ``merge_every``) in
        interpret mode, one query tile."""
        args = (JMetric(metric), self.jq, self.jt, self.stats, jnp.asarray(self.valid), k)
        if merge_every is None:
            out = jscan.pallas_search(*args, q_tile=self.jq.shape[0], t_tile=t_tile, interpret=True)
        else:
            out = jscan.pallas_search_dma(*args, q_tile=self.jq.shape[0], t_tile=t_tile, merge_every=merge_every,
                                          interpret=True)
        return np.asarray(out[0]), np.asarray(out[1])

    def torch_args(self, metric):
        m = MetricKind(metric)
        return (m, self.tq, self.tt, *scan.scan_aux(m, self.tq, torch.from_numpy(self.stats),
                                                    torch.from_numpy(self.valid)))

    def search_args(self, metric):
        return MetricKind(metric), self.tq, self.tt, torch.from_numpy(self.stats), torch.from_numpy(self.valid)


def assert_topk(got, want, exact: bool):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = want
    if exact:
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)
        return
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    tol = RTOL * np.abs(wd) + ATOL
    clear = (np.diff(wd, axis=1, prepend=-np.inf) > tol) & (np.diff(wd, axis=1, append=np.inf) > tol)
    assert clear[wi >= 0].mean() > 0.9
    np.testing.assert_array_equal(gi[clear], wi[clear])
    np.testing.assert_array_equal(gi[wi < 0], wi[wi < 0])


def check_fused(data, metric, k, want):
    """The plain B8/B9 (through both CPU wrappers) and both searches against
    the JAX result."""
    args = data.torch_args(metric)
    assert_topk(scan.fused_topk_plain(*args, k), want, data.exact)
    assert_topk(scan.fused_topk(*args, k), want, data.exact)
    assert_topk(scan.fused_topk_stream(*args, k), want, data.exact)
    assert_topk(scan.search_fused(*data.search_args(metric), k), want, data.exact)
    assert_topk(scan.search_fused_stream(*data.search_args(metric), k), want, data.exact)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_fused_matches_pallas_search(dtype, metric):
    data = Data(dtype)
    check_fused(data, metric, 10, data.pallas(metric, 10))


@pytest.mark.parametrize("k", [1, 40])
@pytest.mark.parametrize("metric", METRICS)
def test_fused_i8_ties_bit_for_bit(metric, k):
    """i8 values from [-3, 3]: equal bin minima everywhere, so the order
    among them (the earlier bin first) is held; k=40 is more than the 4
    bins of one 512-row tile."""
    data = Data("i8", narrow=True, seed=1)
    check_fused(data, metric, k, data.pallas(metric, k))


def test_fewer_live_bins_than_k():
    data = Data("i8", narrow=True, seed=2, live_bins=[3, 9])
    want = data.pallas("l2sq", 8)
    assert np.all(want[1][:, :2] >= 0) and np.all(want[1][:, 2:] == -1)
    assert np.all(want[0][:, 2:] == np.float32(jscan.MASKED))
    check_fused(data, "l2sq", 8, want)


@pytest.mark.parametrize("merge_every", [1, 2])
@pytest.mark.parametrize("dtype,metric", [("i8", "ip"), ("i8", "cos"), ("bf16", "l2sq")])
def test_stream_matches_pallas_search_dma(dtype, metric, merge_every):
    """The JAX kernel's merge interval changes no result: the port's one
    B9 equals it at each."""
    data = Data(dtype, narrow=True, seed=3)
    want = data.pallas(metric, 10, merge_every=merge_every)
    args = data.torch_args(metric)
    assert_topk(scan.fused_topk_stream(*args, 10), want, data.exact)
    assert_topk(scan.search_fused_stream(*data.search_args(metric), 10), want, data.exact)


@pytest.mark.parametrize("dma", [False, True])
def test_tile_sizes_change_no_result(dma):
    """The JAX kernels give one result at 512- and 1024-row tiles: the
    plain version, which has no tiles, is that result."""
    data = Data("i8", narrow=True, seed=4)
    small = data.pallas("l2sq", 10, t_tile=512, merge_every=2 if dma else None)
    large = data.pallas("l2sq", 10, t_tile=1024, merge_every=1 if dma else None)
    np.testing.assert_array_equal(small[0], large[0])
    np.testing.assert_array_equal(small[1], large[1])
    assert_topk(scan.fused_topk_plain(*data.torch_args("l2sq"), 10), small, True)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    data = Data("f32", n=1024, nq=8)
    args = data.torch_args("cos")
    before = (scan.fused_topk.launches, scan.fused_topk_stream.launches)
    want = scan.fused_topk_plain(*args, 5)
    for got in (scan.fused_topk(*args, 5), scan.fused_topk_stream(*args, 5)):
        assert got[0].device.type == "cpu" and got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (scan.fused_topk.launches, scan.fused_topk_stream.launches) == before


def test_fused_refusals():
    data = Data("i8", n=1024, nq=8)
    m, q, t, q_sq, t_sq, pen = data.torch_args("ip")
    for fn in (scan.fused_topk, scan.fused_topk_stream):
        with pytest.raises(TypeError):
            fn(m, q.half(), t.half(), q_sq, t_sq, pen, 10)
        with pytest.raises(TypeError):
            fn(m, q, t.float(), q_sq, t_sq, pen, 10)
        for k in (0, scan.KPAD + 1):
            with pytest.raises(ValueError, match="results per query"):
                fn(m, q, t, q_sq, t_sq, pen, k)
        with pytest.raises(ValueError, match="multiples of 128"):
            fn(m, q, t[:1000], q_sq, t_sq, pen[:1000], 10)
        with pytest.raises(ValueError, match="ip/cos/l2sq"):
            fn(MetricKind.Pearson, q, t, q_sq, t_sq, pen, 10)
    with pytest.raises(ValueError, match="results per query"):
        scan.search_fused(*data.search_args("ip"), scan.KPAD + 1)
    assert scan.fused_topk(m, q, t, q_sq, t_sq, pen, scan.KPAD)[0].shape == (8, scan.KPAD)
