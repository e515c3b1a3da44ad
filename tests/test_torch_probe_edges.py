"""Kernels B3 and B5's plain versions (on the CPU) against the TPU grouped
probe kernels run in Pallas interpret mode, on the layouts where the
tensor-core kernel's tiling can break (chip_smoke.py's PROBE_EDGES, which
holds the kernel against the same plain versions on the card): four cells
of 128 pairs over a 4,096-row table, padded windows of 768 rows:

- every lane its own window (starts mid-bin, lengths 1-300, the last
  ending at the table's last row); one window for the whole cell; lanes
  0-59, 60-70 (a segment across the two 64-lane warpgroups) and 71-127;
  lanes 0-29 on a window across the 127/128 bin edge, 30-40 empty, 41-127
  on a window ending at the table's last row;
- rows 127/128 and 255/256 equal (ties across a bin edge), and the queries
  of lanes 63 and 64 of every cell equal (a tie across the warpgroups);
- widths of 128, 384 and 1,024 elements; k in {1, 3, 10, 128} with bin_m
  in {1, 4, 16}; B5 at 1, 4 and 8 per bin.

Tolerances as tests/test_torch_probe.py's: i8 ip and l2sq equal bit for
bit; i8 cos within 4 f32 ulps of 1 with ids equal (XLA's approximate rsqrt
on the CPU); bf16 within rtol 1e-5, ids equal apart from near ties."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops.pallas_probe import (pallas_ivf_probe_grouped,  # noqa: E402
                                          pallas_ivf_probe_grouped_nofold)

from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402

N, W_PAD, G = 4096, 768, 128
RTOL = 1e-5


def edge_windows(n: int = N):
    """chip_smoke.py's `edge_windows`: four cells, (start, length) by pair."""
    own = [(29 * i + (i % 7) * 3, 1 + (i * 53) % 300) for i in range(127)] + [(n - 200, 200)]
    cells = [own, [(1000, 600)] * 128, [(5, 250)] * 60 + [(300, 700)] * 11 + [(2000, 129)] * 57,
             [(127, 130)] * 30 + [(0, 0)] * 11 + [(n - 300, 300)] * 87]
    return tuple(np.array(x, np.int32) for x in zip(*(w for cell in cells for w in cell)))


class Edges:
    """The table, the pairs' queries and windows, for both packages: the
    port's (start, length, 128-aligned base) per pair, the TPU kernels'
    per-cell window lists (`meta`) and each pair's window in its cell."""

    def __init__(self, dtype: str, w: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.st, self.ln = edge_windows()
        p = self.st.shape[0]
        if dtype == "i8":
            t = rng.integers(-5, 6, (N, w)).astype(np.int8)
            q = t[rng.integers(0, N, p)].copy()
            q[::3] = rng.integers(-5, 6, (q[::3].shape[0], w))
            jdt, tdt = jnp.int8, torch.int8
        else:
            t = rng.standard_normal((N, w)).astype(np.float32)
            q = rng.standard_normal((p, w)).astype(np.float32)
            jdt, tdt = jnp.bfloat16, torch.bfloat16
        t[128], t[256] = t[127], t[255]
        q[64::128] = q[63::128]
        self.jt, self.jq = jnp.asarray(t, jdt), jnp.asarray(q, jdt)
        self.tt, self.tq = torch.from_numpy(t).to(tdt), torch.from_numpy(q).to(tdt)
        tf, qf = np.asarray(self.jt.astype(jnp.float32)), np.asarray(self.jq.astype(jnp.float32))
        self.t_sq = (tf * tf).sum(axis=1, dtype=np.float32)
        self.t_sum = tf.sum(axis=1, dtype=np.float32)
        self.q_sq = (qf * qf).sum(axis=1, dtype=np.float32)
        self.penalty = np.where(rng.random(N) >= 0.1, 0.0, MASKED).astype(np.float32)
        self.base = np.minimum(self.st // 128 * 128, N - W_PAD).astype(np.int32)
        cells = p // G
        self.meta = np.zeros((cells, 8, G), np.int32)
        self.widx = np.full(p, -1, np.int32)
        for c in range(cells):
            seen = {}
            for pair in range(c * G, (c + 1) * G):
                if self.ln[pair] == 0:
                    continue
                key = (int(self.st[pair]), int(self.ln[pair]))
                if key not in seen:
                    wi = seen[key] = len(seen)
                    self.meta[c, :3, wi] = (self.base[pair], self.st[pair] - self.base[pair], self.ln[pair])
                self.widx[pair] = seen[key]
            self.meta[c, 3, 0] = len(seen)

    def pallas_args(self, metric):
        if metric == "ip":
            t_aux = self.penalty[None, :]
        else:
            t_aux = np.stack([self.t_sq, self.t_sum, self.penalty, np.zeros_like(self.penalty)])
        q_aux = np.zeros((self.st.shape[0], 8), np.float32)
        q_aux[:, 0] = self.q_sq
        q_aux[:, 2] = self.widx
        return JMetric(metric), self.jq, jnp.asarray(q_aux), self.jt, jnp.asarray(t_aux), jnp.asarray(self.meta)

    def port_args(self, metric):
        t = torch.from_numpy
        return (MetricKind(metric), self.tq, t(self.q_sq), self.tt, None if metric == "ip" else t(self.t_sq),
                t(self.penalty))

    def b3(self, metric, k, bin_m):
        m, q_g, q_sq, table, t_sq, pen = self.port_args(metric)
        got = probe.grouped_probe(m, q_g, q_sq, table, t_sq, pen, torch.from_numpy(self.st),
                                  torch.from_numpy(self.ln), k, bin_m)
        want = pallas_ivf_probe_grouped(*self.pallas_args(metric), k, W_PAD, G, bin_m, True, 2, 1, True)
        return tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want)

    def b5(self, metric, bin_m):
        m, q_g, q_sq, table, t_sq, pen = self.port_args(metric)
        got = probe.grouped_probe_nofold(m, q_g, q_sq, table, t_sq, pen, torch.from_numpy(self.base),
                                         torch.from_numpy(self.st), torch.from_numpy(self.ln), W_PAD, bin_m)
        want = pallas_ivf_probe_grouped_nofold(*self.pallas_args(metric), W_PAD, G, bin_m, True)
        return tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want)


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
        for row, col in zip(*np.nonzero(gi != wi)):
            near = np.abs(wd[row] - gd[row, col]) <= RTOL * abs(gd[row, col]) + 1e-5
            assert gi[row, col] in wi[row][near], (row, col)


_LAYOUTS = {}


def layout(dtype, w):
    if (dtype, w) not in _LAYOUTS:
        _LAYOUTS[dtype, w] = Edges(dtype, w, seed=w)
    return _LAYOUTS[dtype, w]


B3_CASES = [("i8", 128, m, 10, 4) for m in ("ip", "cos", "l2sq")]
B3_CASES += [("i8", 128, "l2sq", k, b) for k in (1, 3, 128) for b in (1, 4, 16)]
B3_CASES += [("i8", w, "l2sq", 10, 4) for w in (384, 1024)] + [("bf16", w, "cos", 10, 4) for w in (128, 384)]


@pytest.mark.parametrize("dtype,w,metric,k,bin_m", B3_CASES)
def test_grouped_probe_edges_match_pallas(dtype, w, metric, k, bin_m):
    lay = layout(dtype, w)
    got, want = lay.b3(metric, k, bin_m)
    assert_probe_equal(got, want, dtype, metric)
    d, i = got
    assert (i[lay.ln == 0] == -1).all() and (i[lay.ln > 0][:, 0] >= 0).mean() > 0.95  # 1-row windows may be deleted
    # equal queries on one window across the warpgroups (cells 1-3; cell 0's lanes each have their own)
    np.testing.assert_array_equal(i[G + 63 :: G], i[G + 64 :: G])


B5_CASES = [("i8", 128, "l2sq", b) for b in (1, 4, 8)] + [("i8", 1024, "ip", 8), ("bf16", 384, "l2sq", 8)]


@pytest.mark.parametrize("dtype,w,metric,bin_m", B5_CASES)
def test_grouped_probe_nofold_edges_match_pallas(dtype, w, metric, bin_m):
    lay = layout(dtype, w)
    got, want = lay.b5(metric, bin_m)
    assert_probe_equal(got, want, dtype, metric)
    assert (got[1][lay.ln == 0] == -1).all()


def test_ties_across_the_bin_edge_keep_the_lower_row():
    """Lanes 0-29 of the last cell read rows 127-256, where row 128 equals
    row 127 (and 256 equals 255): with one per bin, a query equal to row
    127 finds 127 (bin 0) then 128 (bin 1, the same distance, round 0), and
    the bins keep the lower row of every tie."""
    lay = layout("i8", 128)
    pair = 3 * G
    lay.tq[pair] = lay.tt[127]
    lay.jq = lay.jq.at[pair].set(lay.jt[127])
    lay.q_sq[pair] = lay.t_sq[127]
    lay.penalty[[127, 128]] = 0.0
    try:
        got, want = lay.b3("l2sq", 10, 1)
        assert_probe_equal(got, want, "i8", "l2sq")
        assert got[1][pair][:2].tolist() == [127, 128]
    finally:
        _LAYOUTS.pop(("i8", 128))
