"""Kernels B3 (B4: over packed b1 rows with hamming) and B5's hamming select,
their plain versions on the CPU, against the TPU grouped probe kernels run
in Pallas interpret mode, on layouts where the tensor-core kernel's tiling
can break (chip_smoke.py's PROBE_EDGES holds the kernel against the same
plain versions on the card, at more widths, k and bin_m):

- rows of 1,024 and 3,072 bits (one 128-byte K-block; three) of bytes drawn
  from a few values, so many hamming distances are equal;
- rows 127/128 and 255/256 equal (ties across a bin edge), the queries of
  lanes 63 and 64 of every cell equal (a tie across the two 64-lane
  warpgroups), ~10% deleted rows;
- two cells of 128 pairs over a 2,048-row table, padded windows of 512 rows:
  lanes 0-29 on a window across the 127/128 bin edge, 30-40 empty, 41-70 a
  segment across the warpgroups, 71-127 on a window ending at the table's
  last row; then sixteen runs of eight lanes on windows of 1-300 rows that
  start mid-bin;
- B3 at k in {1, 10} with bin_m in {1, 4, 16}; B5 at 1, 4 and 16 per bin.

Hamming distances are integers held in f32: distances and ids are held
bit for bit."""

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

N, W_PAD, G = 2048, 512, 128


def windows():
    """(start, length) by pair: two cells."""
    first = [(127, 130)] * 30 + [(0, 0)] * 11 + [(300, 200)] * 30 + [(N - 250, 250)] * 57
    runs = [(37 * i + (i % 5) * 11, 1 + (i * 71) % 300) for i in range(16)]
    second = [w for w in runs for _ in range(8)]
    return tuple(np.array(x, np.int32) for x in zip(*(first + second)))


def few_bytes(rng, shape):
    """Random bytes each masked by one of a few values."""
    return (rng.integers(0, 256, shape) & rng.choice([0x11, 0x81, 0xFF], shape)).astype(np.uint8)


class BitEdges:
    """The packed table, the pairs' queries and windows, for both packages:
    the port's (start, length, 128-aligned base) per pair, the TPU kernels'
    per-cell window lists (`meta`) and each pair's window in its cell."""

    def __init__(self, width: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.st, self.ln = windows()
        p = self.st.shape[0]
        t = few_bytes(rng, (N, width))
        q = t[rng.integers(0, N, p)].copy()
        q[::3] = few_bytes(rng, (q[::3].shape[0], width))
        t[128], t[256] = t[127], t[255]
        q[64::G] = q[63::G]
        self.t, self.q = t, q
        self.t_sq = np.unpackbits(t, axis=1).sum(axis=1).astype(np.float32)
        self.q_sq = np.unpackbits(q, axis=1).sum(axis=1).astype(np.float32)
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

    def pallas_args(self):
        q_aux = np.zeros((self.st.shape[0], 8), np.float32)
        q_aux[:, 0] = q_aux[:, 1] = self.q_sq
        q_aux[:, 2] = self.widx
        zeros = np.zeros_like(self.penalty)
        t_aux = np.stack([self.t_sq, zeros, self.penalty, zeros])
        return (JMetric.Hamming, jnp.asarray(self.q), jnp.asarray(q_aux), jnp.asarray(self.t), jnp.asarray(t_aux),
                jnp.asarray(self.meta))

    def port_args(self):
        t = torch.from_numpy
        return (MetricKind.Hamming, t(self.q), t(self.q_sq), t(self.t), t(self.t_sq), t(self.penalty))

    def b3(self, k, bin_m):
        got = probe.grouped_probe(*self.port_args(), torch.from_numpy(self.st), torch.from_numpy(self.ln), k, bin_m)
        want = pallas_ivf_probe_grouped(*self.pallas_args(), k, W_PAD, G, bin_m, True)
        return tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want)

    def b5(self, bin_m):
        got = probe.grouped_probe_nofold(*self.port_args(), torch.from_numpy(self.base), torch.from_numpy(self.st),
                                         torch.from_numpy(self.ln), W_PAD, bin_m)
        want = pallas_ivf_probe_grouped_nofold(*self.pallas_args(), W_PAD, G, bin_m, True)
        return tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want)


_LAYOUTS = {}


def layout(width):
    if width not in _LAYOUTS:
        _LAYOUTS[width] = BitEdges(width, seed=width)
    return _LAYOUTS[width]


def assert_exact(got, want):
    (gd, gi), (wd, wi) = got, want
    assert gd.shape == wd.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("width", [128, 384])
@pytest.mark.parametrize("k,bin_m", [(k, b) for k in (1, 10) for b in (1, 4, 16)])
def test_grouped_probe_b1_matches_pallas(width, k, bin_m):
    lay = layout(width)
    got, want = lay.b3(k, bin_m)
    assert_exact(got, want)
    d, i = got
    assert (i[lay.ln == 0] == -1).all() and (i[lay.ln > 0][:, 0] >= 0).mean() > 0.95
    # the true hamming distance of every row found
    found = np.nonzero(i >= 0)
    bits_q = np.unpackbits(lay.q, axis=1).astype(np.int32)
    bits_t = np.unpackbits(lay.t, axis=1).astype(np.int32)
    np.testing.assert_array_equal(d[found], np.abs(bits_q[found[0]] - bits_t[i[found]]).sum(axis=1))
    # equal queries on one window across the warpgroups
    np.testing.assert_array_equal(i[63], i[64])


@pytest.mark.parametrize("width", [128, 384])
@pytest.mark.parametrize("bin_m", [1, 4, 16])
def test_grouped_probe_nofold_b1_matches_pallas(width, bin_m):
    lay = layout(width)
    got, want = lay.b5(bin_m)
    assert_exact(got, want)
    d, i = got
    assert (i[lay.ln == 0] == -1).all() and (d[lay.ln == 0] == MASKED).all()
    assert not np.isin(np.nonzero(lay.penalty)[0], i).any()


def test_b1_ties_across_the_bin_edge_keep_the_lower_row():
    """Lanes 0-29 read rows 127-256, where row 128 equals row 127 (and 256
    equals 255): with one per bin, a query equal to row 127 finds 127 (bin
    0) then 128 (bin 1, the same distance, round 0), in both packages."""
    lay = BitEdges(128, seed=7)
    lay.q[0] = lay.t[127]
    lay.q_sq[0] = lay.t_sq[127]
    lay.penalty[[127, 128]] = 0.0
    got, want = lay.b3(10, 1)
    assert_exact(got, want)
    assert got[1][0][:2].tolist() == [127, 128] and got[0][0][:2].tolist() == [0.0, 0.0]
