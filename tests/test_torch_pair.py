"""Kernel B6's plain version (the per-query ``pair`` probe) on the CPU
against the TPU kernel `pallas_ivf_probe` run in Pallas interpret mode, and
the ``pair`` flavour's search against the JAX package's
`_ivf_probe_search_dense_pallas`.

Tolerances are test_torch_probe.py's: i8 ip and l2sq and b1 hamming
distances and ids bit for bit; i8 cos within 4 f32 ulps of 1 with ids equal
(the reference takes XLA's approximate rsqrt on the CPU); bf16 and f32
distances within rtol 1e-5, ids equal apart from near ties."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_nofold import BitLayout  # noqa: E402
from test_torch_probe import Layout, assert_probe_equal  # noqa: E402

from usearch_tpu import ivf as jivf  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.enums import ScalarKind as JScalar  # noqa: E402
from usearch_tpu.ops.pallas_probe import pallas_ivf_probe  # noqa: E402

from usearch_torch import ivf  # noqa: E402
from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402

I32 = np.int32


def pair_windows(lay):
    """Per (query, probe): the clamped 128-aligned DMA start, the window's
    offset inside it and its length, as the JAX pair path computes them."""
    st, ln = lay.starts[lay.probes], lay.lens[lay.probes]
    st_c = np.minimum(st // 128 * 128, lay.cap2 - lay.w_pad)
    return st_c.astype(I32), (st - st_c).astype(I32), ln.astype(I32)


def jax_pair(metric, jq, jt, t_aux, lay, k, bin_m):
    st_c, off, ln = pair_windows(lay)
    d, i = pallas_ivf_probe(JMetric(metric), jq, jt, jnp.asarray(t_aux), jnp.asarray(st_c), jnp.asarray(off),
                            jnp.asarray(ln), k, lay.nprobe, lay.w_pad, bin_m, True)
    return np.asarray(d), np.asarray(i)


def torch_pair(metric, tq, tt, q_sq, t_sq, penalty, lay, k, bin_m):
    st_c, off, ln = (torch.from_numpy(x) for x in pair_windows(lay))
    before = probe.pair_probe.launches
    d, i = probe.pair_probe(MetricKind(metric), tq, torch.from_numpy(q_sq), tt,
                            None if t_sq is None else torch.from_numpy(t_sq), torch.from_numpy(penalty), st_c, off,
                            ln, k, lay.w_pad, bin_m)
    assert probe.pair_probe.launches == before  # the CPU runs the plain version
    return d.numpy(), i.numpy()


def numeric_t_aux(lay, metric):
    if metric == "ip":
        return lay.penalty[None, :]
    return np.stack([lay.t_sq, lay.t_sum, lay.penalty, np.zeros_like(lay.penalty)])


def numeric_case(dtype, metric, k, bin_m, lay):
    got = torch_pair(metric, lay.tq, lay.tt, lay.q_sq, None if metric == "ip" else lay.t_sq, lay.penalty, lay, k,
                     bin_m)
    want = jax_pair(metric, lay.jq, lay.jt, numeric_t_aux(lay, metric), lay, k, bin_m)
    assert_probe_equal(got, want, dtype, metric)
    return got


CASES = [(d, m, bm) for d in ("i8", "bf16", "f32") for m in ("ip", "cos", "l2sq") for bm in (4, 10)]


@pytest.mark.parametrize("dtype,metric,bin_m", CASES)
def test_pair_plain_matches_pallas(dtype, metric, bin_m):
    """k = 10 with 4 per bin and with k per bin (exact in each window), 16
    queries of 4 probes each; query 1 probes the empty partition first."""
    lay = Layout(dtype, nq=16, seed=20 + bin_m)
    lay.probes[1] = [4, 0, 1, 2]
    got = numeric_case(dtype, metric, 10, bin_m, lay)
    assert (got[1] >= 0).mean() > 0.9
    assert not np.isin(np.nonzero(~lay.valid)[0], got[1]).any()
    # the empty window adds nothing: query 1 finds rows of partitions 0-2
    found = got[1][1][got[1][1] >= 0]
    assert ((found >= lay.starts[0]) & (found < lay.starts[3])).all()


@pytest.mark.parametrize("bin_m", [4, 10])
def test_pair_b1_plain_matches_pallas(bin_m):
    """Packed 1024-bit rows with hamming (B4's product inside B6), bit for
    bit: pervasive integer ties, a deleted row among planted duplicates."""
    lay = BitLayout(nq=16, seed=30 + bin_m)
    q_sq = np.unpackbits(lay.q, axis=1).sum(axis=1).astype(np.float32)
    got = torch_pair("hamming", torch.from_numpy(lay.q), torch.from_numpy(lay.t), q_sq, lay.pop_t, lay.penalty, lay,
                     10, bin_m)
    t_aux = np.stack([lay.pop_t, np.zeros_like(lay.pop_t), lay.penalty, np.zeros_like(lay.penalty)])
    want = jax_pair("hamming", jnp.asarray(lay.q), jnp.asarray(lay.t), t_aux, lay, 10, bin_m)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.isin(np.nonzero(~lay.valid)[0], got[1]).any()


def planted(probes):
    """An i8 layout, every row live, where rows 5, 6 and 133 (partition 0,
    bins 0 and 1 of its window) and row 300 (partition 2) equal query 0."""
    lay = Layout("i8", nq=8, seed=3)
    t = np.asarray(lay.jt).copy()
    t[300] = t[6]
    q = np.asarray(lay.jq).copy()
    q[0] = t[6]
    lay.jt, lay.jq = jnp.asarray(t), jnp.asarray(q)
    lay.tt, lay.tq = torch.from_numpy(t), torch.from_numpy(q)
    tf, qf = t.astype(np.float32), q.astype(np.float32)
    lay.t_sq, lay.t_sum = (tf * tf).sum(axis=1), tf.sum(axis=1)
    lay.q_sq = (qf * qf).sum(axis=1)
    lay.valid[:] = True
    lay.penalty[:] = 0.0
    lay.probes[0] = probes
    return lay


@pytest.mark.parametrize("probes,first", [([2, 0, 1, 3], [300, 5, 133, 6]), ([0, 2, 1, 3], [5, 133, 6, 300])])
def test_pair_tie_order_is_window_round_bin(probes, first):
    """Equal distances keep the order (window, round, bin): row 300 wins
    when its window is probed first, else comes after rows 5 (round 0, bin
    0), 133 (round 0, bin 1) and 6 (round 1, bin 0)."""
    lay = planted(probes)
    got = numeric_case("i8", "l2sq", 10, 4, lay)
    assert got[1][0][:4].tolist() == first and got[0][0][:4].tolist() == [0.0] * 4


def test_pair_small_surface_pads_with_masked():
    """One probe of a short window and k above its candidates: the rest of
    the row is MASKED with id -1, as the reference pads it."""
    lay = Layout("i8", nq=8, nprobe=1, seed=5)
    lay.probes[:, 0] = 3  # the 5-row partition
    got = numeric_case("i8", "ip", 10, 10, lay)
    assert ((got[1] >= 0).sum(axis=1) <= 5).all()
    assert (got[0][got[1] < 0] == MASKED).all()


def dense_inputs(lay):
    """Both packages' arguments of a dense probe search over ``lay``: the
    partitions' mean rows as centroids, and the (squared norm, sum) stats."""
    tf = np.asarray(lay.jt.astype(jnp.float32))
    cents = np.stack([tf[s : s + max(n, 1)].mean(axis=0) for s, n in zip(lay.starts, lay.lens)]).astype(np.float32)
    stats = np.stack([lay.t_sq, lay.t_sum], axis=1).astype(np.float32)
    j = (lay.jq, jnp.asarray(lay.valid), jnp.asarray(cents), lay.jt, jnp.asarray(stats), jnp.asarray(lay.starts),
         jnp.asarray(lay.lens))
    ct = torch.from_numpy(cents)
    t = (lay.tq, torch.from_numpy(lay.valid), ct, lay.tt, torch.from_numpy(stats), torch.from_numpy(lay.starts),
         torch.from_numpy(lay.lens))
    return j, t, ivf.centroid_groups(ct)


@pytest.mark.parametrize("dtype,metric", [("i8", "ip"), ("i8", "l2sq"), ("i8", "cos"), ("bf16", "l2sq"),
                                          ("f32", "cos")])
def test_pair_search_matches_reference(dtype, metric):
    """The coarse selection, the windows' starts and offsets, the penalty
    row (ip too) and B6: `_ivf_probe_search_dense_pair` against the JAX
    `_ivf_probe_search_dense_pallas`, at 4 per bin (nprobe 3, k 4) and k
    per bin (nprobe 2, k 10)."""
    lay = Layout(dtype, nq=16, seed=40)
    j, t, groups = dense_inputs(lay)
    for nprobe, k in ((3, 4), (2, 10)):
        want = jivf._ivf_probe_search_dense_pallas(JMetric(metric), JScalar(dtype), *j, k, nprobe, lay.w_pad)
        got = ivf._ivf_probe_search_dense_pair(MetricKind(metric), ScalarKind(dtype), *t, k, nprobe, lay.w_pad,
                                               groups)
        assert_probe_equal(tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want), dtype, metric)


def test_pair_wrapper_checks_its_arguments():
    lay = Layout("f32", nq=8, seed=8)
    st_c, off, ln = (torch.from_numpy(x) for x in pair_windows(lay))
    args = [MetricKind.L2sq, lay.tq, torch.from_numpy(lay.q_sq), lay.tt, torch.from_numpy(lay.t_sq),
            torch.from_numpy(lay.penalty), st_c, off, ln, 10, lay.w_pad, 4]
    for i, bad in ((9, 129), (9, 0), (11, 0), (10, 100), (10, lay.cap2 + 128), (6, st_c.long()), (7, off[:, :2]),
                   (4, None), (2, None), (8, None)):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            probe.pair_probe(*wrong)
    with pytest.raises(TypeError):
        probe.pair_probe(MetricKind.Hamming, *args[1:])  # hamming over f32 rows
    # a window outside the table finds nothing
    far = st_c.clone()
    far[0] = lay.cap2
    d, i = probe.pair_probe(*args[:6], far, *args[7:])
    assert (i[0] == -1).all() and (d[0] == MASKED).all() and (i[1] >= 0).any()
