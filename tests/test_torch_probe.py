"""Kernel B3's plain version (on the CPU) against the TPU grouped probe kernel
run in Pallas interpret mode, and the IVF probe's coarse selection and pair
building against the JAX package's.

Tolerances: i8 ip and l2sq distances and ids equal bit for bit. cos within
4 f32 ulps of 1 with ids equal: the reference on the CPU takes ``1/sqrt`` through
XLA's approximate rsqrt and fuses ``1 + acc * scale`` into an FMA, where the
port rounds each operation. bf16 and f32 distances within rtol 1e-5 (f32
sums in another order), ids equal apart from near ties."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from usearch_tpu import ivf as jivf  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops.pallas_probe import pallas_ivf_probe_grouped  # noqa: E402
from usearch_tpu.ops.topk import staged_topk as j_staged_topk  # noqa: E402

from usearch_torch import ivf  # noqa: E402
from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402
from usearch_torch.ops.topk import stable_topk, staged_topk  # noqa: E402

_JAX = {"i8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}
_TORCH = {"i8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
RTOL = 1e-5
#: window lengths: several cross 128-row bin edges, one is empty, one short
LENS = [200, 77, 300, 5, 0, 130, 256, 90, 400, 33, 129, 128]


class Layout:
    """A dense cluster-major table of ``LENS`` windows with ~10% deleted
    rows, rows duplicated inside one bin and across bins (planted ties),
    and the (query, probe) pairs of both packages' `_binned_pairs`."""

    def __init__(self, dtype, w=128, nq=24, nprobe=4, seed=0):
        rng = np.random.default_rng(seed)
        lens = np.array(LENS, dtype=np.int32)
        self.c = len(lens)
        self.starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
        self.lens = lens
        body = int(lens.sum())
        self.cap2 = -(-body // 256) * 256 + 256
        p_win = -(-int(lens.max()) // 8) * 8
        self.w_pad = max(-(-p_win // 128) * 128 + 128, 256)
        self.nprobe = nprobe
        if dtype == "i8":
            t = np.zeros((self.cap2, w), np.int8)
            t[:body] = rng.integers(-5, 6, (body, w))  # small values: many exact ties
            q = rng.integers(-5, 6, (nq, w)).astype(np.int8)
        else:
            t = np.zeros((self.cap2, w), np.float32)
            t[:body] = rng.standard_normal((body, w))
            q = rng.standard_normal((nq, w)).astype(np.float32)
        t[5] = t[6]
        t[133] = t[6]
        t[7] = 0  # a zero row: cos's zero-norm rules
        self.valid = rng.random(self.cap2) >= 0.1
        self.jt, self.jq = jnp.asarray(t, _JAX[dtype]), jnp.asarray(q, _JAX[dtype])
        self.tt, self.tq = torch.from_numpy(t).to(_TORCH[dtype]), torch.from_numpy(q).to(_TORCH[dtype])
        tf = np.asarray(self.jt.astype(jnp.float32))
        self.t_sq = (tf * tf).sum(axis=1, dtype=np.float32)
        self.t_sum = tf.sum(axis=1, dtype=np.float32)
        qf = np.asarray(self.jq.astype(jnp.float32))
        self.q_sq = (qf * qf).sum(axis=1, dtype=np.float32)
        self.penalty = np.where(self.valid, 0.0, MASKED).astype(np.float32)
        self.probes = np.stack([rng.choice(self.c, nprobe, replace=False) for _ in range(nq)]).astype(np.int32)
        (self.q_g, self.qid_s, self.widx, self.meta, self.order, self.p0,
         self.p_total) = jivf._binned_pairs(self.jq, jnp.asarray(self.probes), jnp.asarray(self.starts),
                                            jnp.asarray(self.lens), self.cap2, self.w_pad, nprobe, 128)

    def pair_windows(self):
        """Per pair (DMA start, offset, length) from the JAX cell metadata."""
        meta, widx = np.asarray(self.meta), np.asarray(self.widx).reshape(-1)
        cell = np.arange(self.p_total) // 128
        return meta[cell, 0, widx], meta[cell, 1, widx], meta[cell, 2, widx]

    def pallas(self, metric, k, bin_m, with_aux=True):
        if metric == "ip":
            t_aux = self.penalty[None, :]
        else:
            t_aux = np.stack([self.t_sq, self.t_sum, self.penalty, np.zeros_like(self.penalty)])
        qid = np.asarray(self.qid_s)
        q_aux = np.zeros((self.p_total, 8), np.float32)
        q_aux[:, 0] = self.q_sq[qid]
        q_aux[:, 2] = np.asarray(self.widx).reshape(-1)
        d, i = pallas_ivf_probe_grouped(JMetric(metric), self.q_g, jnp.asarray(q_aux), self.jt,
                                        jnp.asarray(t_aux), self.meta, k, self.w_pad, 128, bin_m, True, 2, 1,
                                        with_aux)
        return np.asarray(d), np.asarray(i)

    def plain(self, metric, k, bin_m, with_aux=True):
        qid = np.asarray(self.qid_s)
        st_c, off, ln = self.pair_windows()
        d, i = probe.grouped_probe(
            MetricKind(metric), self.tq[torch.from_numpy(qid.copy())].contiguous(), torch.from_numpy(self.q_sq[qid]),
            self.tt, None if metric == "ip" else torch.from_numpy(self.t_sq),
            torch.from_numpy(self.penalty) if with_aux else None,
            torch.from_numpy((st_c + off).astype(np.int32)), torch.from_numpy(ln.astype(np.int32)), k, bin_m)
        return d.numpy(), i.numpy()


def assert_probe_equal(got, want, dtype, metric):
    (gd, gi), (wd, wi) = got, want
    assert gd.shape == wd.shape and gi.shape == wi.shape
    if dtype == "i8" and metric != "cos":
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)
    elif dtype == "i8":
        np.testing.assert_allclose(gd, wd, rtol=0, atol=4.8e-7)
        np.testing.assert_array_equal(gi, wi)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-5)
        # a different id only where the reference's distances tie nearby
        for row, col in zip(*np.nonzero(gi != wi)):
            near = np.abs(wd[row] - gd[row, col]) <= RTOL * abs(gd[row, col]) + 1e-5
            assert gi[row, col] in wi[row][near], (row, col)


CASES = [(d, m, bm, True) for d in ("i8", "bf16", "f32") for m in ("ip", "cos", "l2sq") for bm in (4, 10)]
CASES += [(d, "ip", bm, False) for d in ("i8", "bf16", "f32") for bm in (4, 10)]


@pytest.mark.parametrize("dtype,metric,bin_m,with_aux", CASES)
def test_grouped_probe_matches_pallas(dtype, metric, bin_m, with_aux):
    """k = 10 with bin_m 4 (wide surfaces) and bin_m = k (exact in window);
    ``with_aux=False`` is the fully-live ip path (every row live)."""
    lay = Layout(dtype, seed=bin_m)
    if not with_aux:
        lay.valid[:] = True
        lay.penalty[:] = 0.0
    got = lay.plain(metric, 10, bin_m, with_aux)
    want = lay.pallas(metric, 10, bin_m, with_aux)
    assert_probe_equal(got, want, dtype, metric)
    real = got[1][: lay.p0]  # pad pairs sort last and find nothing
    assert (real >= 0).mean() > 0.7 and (got[1][lay.p0 :] == -1).all()
    assert not np.isin(np.nonzero(~lay.valid)[0], got[1]).any()


@pytest.mark.parametrize("k,bin_m", [(3, 3), (128, 16)])
def test_grouped_probe_k_extremes(k, bin_m):
    """k below the 8-row pad, and k = 128 with 16 per bin, on tie-heavy i8."""
    lay = Layout("i8", nq=8, seed=k)
    assert_probe_equal(lay.plain("l2sq", k, bin_m), lay.pallas("l2sq", k, bin_m), "i8", "l2sq")


def test_grouped_probe_planted_ties():
    """Rows 5 and 6 tie inside bin 0, row 133 ties with them from bin 1: a
    query equal to row 6 gets them in the reference's order."""
    lay = Layout("i8", nq=4, seed=3)
    lay.valid[:] = True
    lay.penalty[:] = 0.0
    lay.jq = lay.jq.at[0].set(lay.jt[6])
    lay.tq[0] = lay.tt[6]
    lay.q_sq[0] = lay.t_sq[6]
    lay.probes[0] = [0, 1, 2, 3]
    (lay.q_g, lay.qid_s, lay.widx, lay.meta, lay.order, lay.p0,
     lay.p_total) = jivf._binned_pairs(lay.jq, jnp.asarray(lay.probes), jnp.asarray(lay.starts),
                                       jnp.asarray(lay.lens), lay.cap2, lay.w_pad, lay.nprobe, 128)
    got, want = lay.plain("l2sq", 10, 4), lay.pallas("l2sq", 10, 4)
    assert_probe_equal(got, want, "i8", "l2sq")
    # query 0's pair with partition 0 (rows 0-199); candidates in (round,
    # bin) order: row 5 (round 0, bin 0), row 133 (round 0, bin 1), row 6
    # (round 1, bin 0)
    pair = int(np.nonzero(np.asarray(lay.order) == 0)[0][0])
    assert got[1][pair][:3].tolist() == [5, 133, 6]


def test_binned_pairs_matches_reference():
    lay = Layout("i8", nq=50, nprobe=5, seed=4)
    q_g, qid_s, st_c, off, ln, order, p0, p_total = ivf._binned_pairs(
        lay.tq, torch.from_numpy(lay.probes), torch.from_numpy(lay.starts), torch.from_numpy(lay.lens),
        lay.cap2, lay.w_pad, lay.nprobe)
    assert (p0, p_total) == (lay.p0, lay.p_total)
    np.testing.assert_array_equal(order.numpy(), np.asarray(lay.order))
    np.testing.assert_array_equal(qid_s.numpy(), np.asarray(lay.qid_s))
    np.testing.assert_array_equal(q_g.numpy(), np.asarray(lay.q_g))
    want = lay.pair_windows()
    for got, ref in zip((st_c, off, ln), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (st_c.numpy() % 128 == 0).all() and (st_c.numpy() + lay.w_pad <= lay.cap2).all()


@pytest.mark.parametrize("metric", ["ip", "cos", "l2sq"])
def test_probe_select_matches_reference(metric):
    """Chunks split from one cluster share its centroid and tie exactly:
    both packages take the lower chunk first. Empty chunks rank last."""
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((10, 64)).astype(np.float32)
    chunks = cents[[0, 1, 1, 1, 2, 3, 3, 4, 5, 6, 6, 7, 8, 9, 9, 9]]
    lens = np.full(len(chunks), 50, np.int32)
    lens[6] = 0
    qf = rng.standard_normal((300, 64)).astype(np.float32)
    qf[:20] = cents[1] + 0.01 * rng.standard_normal((20, 64))
    for nprobe in (2, 5):
        want = np.asarray(jivf._probe_select(JMetric(metric), jnp.asarray(qf), jnp.asarray(chunks),
                                             jnp.asarray(lens), nprobe))
        ct = torch.from_numpy(chunks)
        got = ivf._probe_select(MetricKind(metric), torch.from_numpy(qf), ct, torch.from_numpy(lens), nprobe,
                                ivf.centroid_groups(ct)).numpy()
        np.testing.assert_array_equal(got, want)
        assert not (got == 6).any()


def test_probe_select_chunks_queries():
    """More than COARSE_QCHUNK queries: the same selection as one pass."""
    rng = np.random.default_rng(6)
    cents = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    qf = torch.from_numpy(rng.standard_normal((ivf.COARSE_QCHUNK + 300, 16)).astype(np.float32))
    got = ivf._probe_select(MetricKind.L2sq, qf, cents, None, 7)
    one = stable_topk(ivf._score_centroids(MetricKind.L2sq, qf, cents), 7)[1]
    np.testing.assert_array_equal(got.numpy(), one.numpy())


def test_staged_topk_matches_reference_where_exact():
    """The port's merge is exact; it equals the JAX `staged_topk` wherever
    that one equals ``lax.top_k`` (asserted first), ids included."""
    rng = np.random.default_rng(7)
    dist = rng.standard_normal((16, 4096)).astype(np.float32)
    dist[:, 100:104] = dist[:, 50:51]  # ties
    cand = rng.integers(0, 1 << 30, (16, 4096)).astype(np.int32)
    wd, wi = (np.asarray(x) for x in j_staged_topk(jnp.asarray(dist), jnp.asarray(cand), 10))
    neg, sel = jax.lax.top_k(-jnp.asarray(dist), 10)
    np.testing.assert_array_equal(wd, -np.asarray(neg))
    np.testing.assert_array_equal(wi, np.take_along_axis(cand, np.asarray(sel), 1))
    gd, gi = staged_topk(torch.from_numpy(dist), torch.from_numpy(cand), 10)
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_wrapper_runs_plain_on_cpu_and_checks_arguments():
    lay = Layout("f32", nq=8, seed=8)
    before = probe.grouped_probe.launches
    lay.plain("ip", 10, 4)
    assert probe.grouped_probe.launches == before  # no kernel on the CPU
    q = lay.tq[:128].contiguous()
    args = [MetricKind.IP, q, torch.zeros(128), lay.tt, None, None,
            torch.zeros(128, dtype=torch.int32), torch.zeros(128, dtype=torch.int32), 10, 4]
    for i, bad in ((8, 129), (9, 17), (1, q[:100]), (6, torch.zeros(128, dtype=torch.int64))):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            probe.grouped_probe(*wrong)
    with pytest.raises(ValueError):
        probe.grouped_probe(MetricKind.L2sq, *args[1:])  # l2sq without t_sq
