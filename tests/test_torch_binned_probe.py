"""Kernel B7's plain version (the packed-key binned probe of the ``bin``
flavour) on the CPU against the TPU kernel `pallas_ivf_probe_binned` run in
Pallas interpret mode, and the ``bin`` flavour's search against the JAX
package's `_ivf_probe_search_dense_binned`.

B7's keys are raw i8 dots, integers held in f32: the whole ``[P, out_pad]``
surfaces are held bit for bit, for ``pack`` and for ``fminarg``, each
against its own reference. The searches' ip distances are bit for bit, cos
and l2sq within 4 f32 ulps of 1 (their square roots and divisions), ids
equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_probe import Layout  # noqa: E402

from usearch_tpu import ivf as jivf  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.enums import ScalarKind as JScalar  # noqa: E402
from usearch_tpu.ops.pallas_probe import pallas_ivf_probe_binned  # noqa: E402

from usearch_torch import ivf  # noqa: E402
from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402

#: 4 f32 ulps of 1: square roots and a division taken in another order
ULPS4 = 4.8e-7


def full_range(lay, w, seed):
    """Replace the layout's tables with full-range i8 rows of width ``w``
    (dots past 2**24 above ~1,040 columns), keeping the planted duplicates
    (rows 5, 6 and 133) and a query equal to row 6."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-128, 128, (lay.cap2, w)).astype(np.int8)
    t[5] = t[133] = t[6]
    q = rng.integers(-128, 128, (np.asarray(lay.jq).shape[0], w)).astype(np.int8)
    q[0] = t[6]
    lay.jt, lay.jq = jnp.asarray(t), jnp.asarray(q)
    lay.tt, lay.tq = torch.from_numpy(t), torch.from_numpy(q)
    (lay.q_g, lay.qid_s, lay.widx, lay.meta, lay.order, lay.p0,
     lay.p_total) = jivf._binned_pairs(lay.jq, jnp.asarray(lay.probes), jnp.asarray(lay.starts),
                                       jnp.asarray(lay.lens), lay.cap2, lay.w_pad, lay.nprobe, 128)


def compare(lay, bw, keep, sel):
    q_aux = np.zeros((lay.p_total, 8), np.float32)
    q_aux[:, 2] = np.asarray(lay.widx).reshape(-1)
    want_d, want_i = (np.asarray(x) for x in pallas_ivf_probe_binned(
        lay.q_g, jnp.asarray(q_aux), lay.jt, lay.meta, lay.w_pad, 128, bw, keep, 1, sel, True))
    st_c, _, _ = lay.pair_windows()
    before = probe.binned_probe.launches
    got_d, got_i = probe.binned_probe(torch.from_numpy(np.asarray(lay.q_g).copy()), lay.tt,
                                      torch.from_numpy(st_c.astype(np.int32)), lay.w_pad, bw, keep, sel)
    assert probe.binned_probe.launches == before  # the CPU runs the plain version
    assert got_d.shape == (lay.p_total, probe.binned_width(keep, lay.w_pad, bw)) == want_d.shape
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    return got_d.numpy(), got_i.numpy()


@pytest.mark.parametrize("sel", ["pack", "fminarg"])
@pytest.mark.parametrize("bw,keep", [(32, 4), (8, 1)])
def test_binned_plain_matches_pallas(sel, bw, keep):
    """Tie-heavy small i8 values with duplicated rows: every pair's whole
    padded window, pad pairs included, the lower row first on equal dots."""
    lay = Layout("i8", nq=16, seed=50 + bw)
    got_d, got_i = compare(lay, bw, keep, sel)
    n_cand = keep * (lay.w_pad // bw)
    assert (got_i[:, :n_cand] >= 0).all() and (got_i[:, n_cand:] == -1).all()
    assert (got_d[:, n_cand:] == MASKED).all()


@pytest.mark.parametrize("sel", ["pack", "fminarg"])
def test_binned_plain_matches_pallas_wide_rows(sel):
    """Full-range rows 1,152 wide, where ``fminarg``'s f32 keys round: each
    selection equals its own reference; the duplicates of row 6 surface
    for query 0, the lowest first."""
    lay = Layout("i8", nq=8, seed=60)
    lay.probes[0] = [0, 2, 5, 8]
    full_range(lay, 1152, 61)
    got_d, got_i = compare(lay, 32, 4, sel)
    # query 0's pair with partition 0: rows 5 and 6 are rounds 0 and 1 of
    # bin 0, row 133 round 0 of bin 4
    pair = int(np.nonzero(np.asarray(lay.order) == 0)[0][0])
    nbw = lay.w_pad // 32
    assert [got_i[pair, 0], got_i[pair, nbw], got_i[pair, 4]] == [5, 6, 133]


def direct_layout(seed, n_parts=16, clen=96, w=128):
    """tests/test_probe.py's direct small-window layout: equal partitions of
    full-range i8 rows, windows padded past their neighbours' rows."""
    rng = np.random.default_rng(seed)
    cap2 = n_parts * clen + 128
    n = n_parts * clen
    table = np.zeros((cap2, w), np.int8)
    table[:n] = rng.integers(-127, 128, (n, w), dtype=np.int8)
    valid = np.zeros(cap2, bool)
    valid[:n] = True
    starts = np.arange(n_parts, dtype=np.int32) * clen
    lens = np.full(n_parts, clen, np.int32)
    cents = np.stack([table[s : s + clen].astype(np.float32).mean(0) for s in starts])
    tf = table.astype(np.float32)
    stats = np.stack([(tf * tf).sum(1), tf.sum(1)], axis=1).astype(np.float32)
    q = rng.integers(-127, 128, (5, w), dtype=np.int8)
    w_pad = ((clen + 127) // 128 + 1) * 128
    return q, valid, cents, table, stats, starts, lens, w_pad


@pytest.mark.parametrize("metric", ["ip", "cos", "l2sq"])
def test_binned_search_matches_reference(metric):
    """tests/test_probe.py:172's direct call, per metric, with 10% of the
    rows deleted: the merged keys, the validity mask, the distances from
    the stats and the removal of rows that two windows both hold."""
    q, valid, cents, table, stats, starts, lens, w_pad = direct_layout(3)
    valid[np.random.default_rng(4).random(valid.shape[0]) < 0.1] = False
    args = (q, valid, cents, table, stats, starts, lens)
    want_d, want_i = (np.asarray(x) for x in jivf._ivf_probe_search_dense_binned(
        JMetric(metric), JScalar.I8, *(jnp.asarray(a) for a in args), 10, 4, w_pad))
    ct = torch.from_numpy(cents)
    got_d, got_i = ivf._ivf_probe_search_dense_binned(
        MetricKind(metric), ScalarKind.I8, *(torch.from_numpy(a) for a in args), 10, 4, w_pad,
        ivf.centroid_groups(ct), 32, 4, "pack")
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    if metric == "ip":
        np.testing.assert_array_equal(got_d.numpy(), want_d)
    else:
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=ULPS4 * max(1.0, float(np.abs(want_d).max())))
    found = got_i.numpy()[got_i.numpy() >= 0]
    assert valid[found].all() and found.size > 0
    for row in got_i.numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    if metric == "ip":  # the distances are the true ones
        qf, tf = q.astype(np.float32), table.astype(np.float32)
        for qi, (d_row, i_row) in enumerate(zip(got_d.numpy(), got_i.numpy())):
            ok = i_row >= 0
            np.testing.assert_array_equal(d_row[ok], 1.0 - tf[i_row[ok]] @ qf[qi])


def test_binned_wrapper_checks_its_arguments():
    lay = Layout("i8", nq=8, seed=7)
    st_c, _, _ = lay.pair_windows()
    args = [torch.from_numpy(np.asarray(lay.q_g).copy()), lay.tt, torch.from_numpy(st_c.astype(np.int32)),
            lay.w_pad, 32, 4, "pack"]
    for i, bad in ((6, "dotonly"), (6, "other"), (4, 64), (4, 24), (5, 17), (5, 0), (3, 100), (2, args[2].long())):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            probe.binned_probe(*wrong)
    wrong = list(args)
    wrong[4], wrong[5], wrong[6] = 128, 8, "fminarg"
    probe.binned_probe(*wrong)  # fminarg takes bins of up to 128 rows
    with pytest.raises(TypeError):
        probe.binned_probe(args[0].float(), args[1].float(), *args[2:])
    far = args[2].clone()
    far[:16] = lay.cap2  # a padded window past the table finds nothing
    d, i = probe.binned_probe(args[0], args[1], far, *args[3:])
    assert (i[:16] == -1).all() and (d[:16] == MASKED).all() and (i[16:] >= 0).any()
