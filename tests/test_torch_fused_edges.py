"""The edges of the fused running top-k (kernels B8/B9) that the tensor-core
design of csrc/fused.cu has to keep: their plain version, which
`fused_topk` and `fused_topk_stream` run for CPU tensors, against the TPU
kernels `pallas_search` and `pallas_search_dma` in Pallas interpret mode.

Each table plants bins of equal minima: bin 1 holds the queries, and bins
2 (across the edge of a 256-row tile), 7 and 8 (across the edge of an
8-bin merge group) and the last bin are copies of it, rows and deleted
rows alike. Tables of 24 bins (three merge groups) and of 19 bins (a half
last 256-row tile), 40 queries (no full tile of 64 or 128), k = 1, 10 and
128 (more than the bins), and a table with fewer live bins than k.

i8: equal bit for bit, ids, tie order and the ``(3e38, -1)`` padding
included. bf16 and f32: distances within rtol 1e-5 and an atol of 1e-6
times the largest q_sq + t_sq (f32 sums in another order; l2sq's q_sq +
t_sq - 2 dot cancels to near 0 on the planted copies of the queries, so its
rounding is relative to those terms), ids equal wherever both neighbouring
distances are further apart than that, and within every run of equal
distances the same ids in increasing order (the earlier bin first)."""

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
RTOL, ATOL_REL = 1e-5, 1e-6
KS = (1, 10, scan.KPAD)
NQ = 40
#: bins that copy bin 1: across a 256-row tile edge (1 | 2) and across a
#: merge-group edge (7 | 8); the last bin is added per table
COPIES = (2, 7, 8)


class EdgeData:
    """``n_bins`` bins of 128 rows of width 128 in both frameworks, ~10%
    deleted, rows 0-2 and query 0 zero; bin 1 holds the queries and the
    bins of COPIES and the last bin copy it; ``live_bins`` keeps only those
    bins live."""

    def __init__(self, dtype, n_bins, seed=0, live_bins=None):
        rng = np.random.default_rng(seed)
        n, w = n_bins * 128, 128
        if dtype == "i8":
            t = rng.integers(-20, 21, (n, w)).astype(np.int8)
            q = rng.integers(-20, 21, (NQ, w)).astype(np.int8)
        else:
            t = rng.standard_normal((n, w)).astype(np.float32)
            q = rng.standard_normal((NQ, w)).astype(np.float32)
        q[0] = 0
        t[128 : 128 + NQ] = q
        t[:3] = 0
        self.valid = rng.random(n) >= 0.1
        if live_bins is not None:
            self.valid[:] = False
            for b in live_bins:
                self.valid[b * 128 : (b + 1) * 128] = True
        for b in COPIES + (n_bins - 1,):
            t[b * 128 : (b + 1) * 128] = t[128:256]
            if live_bins is None:
                self.valid[b * 128 : (b + 1) * 128] = self.valid[128:256]
        self.n_bins = n_bins
        self.exact = dtype == "i8"
        self.jt, self.jq = jnp.asarray(t, _JAX[dtype]), jnp.asarray(q, _JAX[dtype])
        self.tt, self.tq = torch.from_numpy(t).to(_TORCH[dtype]), torch.from_numpy(q).to(_TORCH[dtype])
        self.stats = np.array(j_row_stats(self.jt, usearch_tpu.ScalarKind(dtype)))
        q32 = np.asarray(self.jq, np.float32)
        self.atol = ATOL_REL * float((q32 * q32).sum(1).max() + self.stats[:, 0].max())

    def pallas(self, metric, k, dma: bool):
        """`pallas_search` (or `pallas_search_dma`, merging every 8 bins
        where the bin count allows, else every bin) in interpret mode, one
        128-row bin per tile, one query tile."""
        args = (JMetric(metric), self.jq, self.jt, self.stats, jnp.asarray(self.valid), k)
        if dma:
            every = 8 if self.n_bins % 8 == 0 else 1
            out = jscan.pallas_search_dma(*args, q_tile=NQ, t_tile=128, merge_every=every, interpret=True)
        else:
            out = jscan.pallas_search(*args, q_tile=NQ, t_tile=128, interpret=True)
        return np.asarray(out[0]), np.asarray(out[1])

    def torch_args(self, metric):
        m = MetricKind(metric)
        return (m, self.tq, self.tt, *scan.scan_aux(m, self.tq, torch.from_numpy(self.stats),
                                                    torch.from_numpy(self.valid)))


def tie_runs(d):
    """Per row, the (start, stop) of every run of two or more equal values."""
    out = []
    for row in d:
        runs, lo = [], 0
        for j in range(1, len(row) + 1):
            if j == len(row) or row[j] != row[lo]:
                if j - lo > 1:
                    runs.append((lo, j))
                lo = j
        out.append(runs)
    return out


def assert_topk(got, want, exact: bool, atol: float):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = want
    if exact:
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=atol)
        tol = RTOL * np.abs(wd) + atol
        clear = (np.diff(wd, axis=1, prepend=-np.inf) > tol) & (np.diff(wd, axis=1, append=np.inf) > tol)
        np.testing.assert_array_equal(gi[clear], wi[clear])
        np.testing.assert_array_equal(gi[wi < 0], wi[wi < 0])
    # the planted ties: the earlier bin first, on both sides
    for d, i in ((gd, gi), (wd, wi)):
        for row, runs in enumerate(tie_runs(d)):
            for lo, hi in runs:
                ids = i[row, lo:hi]
                live = ids[ids >= 0]
                assert np.all(np.diff(live) > 0), (row, ids)
    for row, runs in enumerate(tie_runs(wd)):
        for lo, hi in runs:
            if hi - lo > 1 and np.all(gd[row, lo:hi] == gd[row, lo]):
                assert sorted(gi[row, lo:hi]) == sorted(wi[row, lo:hi]), row


def check(data, metric):
    """Each TPU kernel runs once, at k = KPAD: its list is sorted and stable
    (ties in bin order), so its first k entries are the list of any smaller
    k. The port's wrappers (on CPU tensors, their plain version) run at
    every k of KS."""
    args = data.torch_args(metric)
    want = data.pallas(metric, scan.KPAD, dma=False)
    want_dma = data.pallas(metric, scan.KPAD, dma=True)
    np.testing.assert_array_equal(want[0], want_dma[0])
    np.testing.assert_array_equal(want[1], want_dma[1])
    planted = 0
    for k in KS:
        head, head_dma = (tuple(x[:, :k] for x in w) for w in (want, want_dma))
        planted += sum(hi - lo for runs in tie_runs(head[0]) for lo, hi in runs)
        assert_topk(scan.fused_topk(*args, k), head, data.exact, data.atol)
        assert_topk(scan.fused_topk_stream(*args, k), head_dma, data.exact, data.atol)
    assert planted > 0  # the ties are there to be held


@pytest.mark.parametrize("n_bins", [24, 19])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_fused_edges_match_pallas(metric, dtype, n_bins):
    """Equal minima across a tile edge, a merge-group edge and in the half
    last tile; 40 queries; k = 1, 10, 128."""
    check(EdgeData(dtype, n_bins, seed=n_bins), metric)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_edges_fewer_live_bins_than_k(dtype):
    """Three live bins, two of them equal copies of bin 1 (2 and the last):
    three entries in bin order, then ``(MASKED, -1)``."""
    data = EdgeData(dtype, 19, seed=5, live_bins=(1, 2, 18))
    want = data.pallas("l2sq", 10, dma=False)
    assert np.all(want[1][:, :3] >= 0) and np.all(want[1][:, 3:] == -1)
    assert np.all(want[0][:, 3:] == np.float32(jscan.MASKED))
    args = data.torch_args("l2sq")
    for fn in (scan.fused_topk_plain, scan.fused_topk, scan.fused_topk_stream):
        got = fn(*args, 10)
        assert_topk(got, want, data.exact, data.atol)
        assert np.array_equal(np.asarray(got[1])[:, :3] // 128, np.tile([1, 2, 18], (NQ, 1)))
