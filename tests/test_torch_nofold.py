"""Kernel B5's plain version (the fold-free grouped probe) and kernel B3's
b1/hamming plain version (B4), on the CPU, against the TPU kernels run in
Pallas interpret mode: `pallas_ivf_probe_grouped_nofold` and
`pallas_ivf_probe_grouped` over packed bit rows.

Hamming distances are integers held in f32, so both are held bit for bit:
B5's whole ``[P, out_pad]`` surfaces (round-major columns, ``MASKED``/-1
fill) and B3's ``[P, k]`` distances and ids."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from usearch_tpu import ivf as jivf  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops.pallas_probe import pallas_ivf_probe_grouped, pallas_ivf_probe_grouped_nofold  # noqa: E402

from usearch_torch import ivf  # noqa: E402
from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402

#: window lengths: several cross 128-row bin edges, one is empty, one short;
#: the last window's padded window is clamped at cap2 - w_pad
LENS = [200, 77, 300, 5, 0, 130, 256, 90, 400, 33, 129, 128]


class BitLayout:
    """A dense cluster-major table of packed 1024-bit rows in ``LENS``
    windows: bytes drawn from a few values (many equal hamming distances),
    rows duplicated inside a bin and across bins, ~10% deleted rows, and
    the (query, probe) pairs of both packages' `_binned_pairs`."""

    def __init__(self, nq=24, nprobe=4, seed=0, width=128):
        rng = np.random.default_rng(seed)
        lens = np.array(LENS, dtype=np.int32)
        self.starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
        self.lens = lens
        body = int(lens.sum())
        self.cap2 = -(-body // 256) * 256 + 256
        p_win = -(-int(lens.max()) // 8) * 8
        self.w_pad = max(-(-p_win // 128) * 128 + 128, 256)
        self.nprobe = nprobe
        t = np.zeros((self.cap2, width), np.uint8)
        t[:body] = rng.integers(0, 256, (body, width)) & rng.choice([0x11, 0x81, 0xFF], (body, width))
        t[5] = t[6]
        t[133] = t[6]
        q = t[rng.integers(0, body, nq)].copy()
        q[0] = t[6]
        q[1] ^= 0x10
        self.valid = rng.random(self.cap2) >= 0.1
        self.valid[6] = False  # a deleted row among the planted ties
        self.t, self.q = t, q
        self.pop_t = np.unpackbits(t, axis=1).sum(axis=1).astype(np.float32)
        self.penalty = np.where(self.valid, 0.0, MASKED).astype(np.float32)
        self.probes = np.stack([rng.choice(len(lens), nprobe, replace=False) for _ in range(nq)]).astype(np.int32)
        self.probes[0, :4] = [0, 1, 2, len(lens) - 1]
        (self.q_g, self.qid_s, self.widx, self.meta, self.order, self.p0,
         self.p_total) = jivf._binned_pairs(jnp.asarray(q), jnp.asarray(self.probes), jnp.asarray(self.starts),
                                            jnp.asarray(lens), self.cap2, self.w_pad, nprobe, 128)
        self.q_sq = np.unpackbits(np.asarray(self.q_g), axis=1).sum(axis=1).astype(np.float32)

    def pair_windows(self):
        """Per pair (DMA start, offset, length) from the JAX cell metadata."""
        meta, widx = np.asarray(self.meta), np.asarray(self.widx).reshape(-1)
        cell = np.arange(self.p_total) // 128
        return meta[cell, 0, widx], meta[cell, 1, widx], meta[cell, 2, widx]

    def jax_aux(self):
        q_aux = np.zeros((self.p_total, 8), np.float32)
        q_aux[:, 0] = q_aux[:, 1] = self.q_sq
        q_aux[:, 2] = np.asarray(self.widx).reshape(-1)
        t_aux = np.stack([self.pop_t, np.zeros_like(self.pop_t), self.penalty, np.zeros_like(self.penalty)])
        return jnp.asarray(q_aux), jnp.asarray(t_aux)

    def torch_args(self):
        st_c, off, ln = self.pair_windows()
        i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))  # noqa: E731
        return (MetricKind.Hamming, torch.from_numpy(np.asarray(self.q_g).copy()), torch.from_numpy(self.q_sq),
                torch.from_numpy(self.t), torch.from_numpy(self.pop_t), torch.from_numpy(self.penalty),
                i32(st_c), i32(st_c + off), i32(ln))

    def nofold(self, bin_m):
        q_aux, t_aux = self.jax_aux()
        d, i = pallas_ivf_probe_grouped_nofold(JMetric.Hamming, self.q_g, q_aux, jnp.asarray(self.t), t_aux,
                                               self.meta, self.w_pad, 128, bin_m, True)
        return np.asarray(d), np.asarray(i)

    def grouped(self, k, bin_m):
        q_aux, t_aux = self.jax_aux()
        d, i = pallas_ivf_probe_grouped(JMetric.Hamming, self.q_g, q_aux, jnp.asarray(self.t), t_aux, self.meta, k,
                                        self.w_pad, 128, bin_m, True)
        return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("bin_m", [4, 8, 16])
def test_nofold_plain_matches_pallas(bin_m):
    """B5's [P, out_pad] surfaces equal the TPU kernel's bit for bit: the
    bin_m best of every bin, lower row first on ties, round-major, with
    ``MASKED``/-1 past ``bin_m * nb_w``, at empty slots and at deleted
    rows."""
    lay = BitLayout(seed=bin_m)
    st_c, off, _ = lay.pair_windows()
    assert ((st_c == lay.cap2 - lay.w_pad) & (off >= 128)).any()  # a clamped padded window
    want_d, want_i = lay.nofold(bin_m)
    args = lay.torch_args()
    before = probe.grouped_probe_nofold.launches
    got_d, got_i = probe.grouped_probe_nofold(*args, lay.w_pad, bin_m)
    assert probe.grouped_probe_nofold.launches == before  # the CPU runs the plain version
    assert got_d.shape == (lay.p_total, probe.nofold_width(bin_m, lay.w_pad)) == want_d.shape
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    n_cand = bin_m * (lay.w_pad // 128)
    assert (got_i[:, n_cand:] == -1).all() and (got_d[:, n_cand:] == MASKED).all()
    assert (got_i[: lay.p0] >= 0).sum() > 0.5 * lay.p0 * min(bin_m, 4)
    assert not np.isin(np.nonzero(~lay.valid)[0], got_i.numpy()).any()


def test_nofold_planted_ties_keep_row_order():
    """Rows 5 and 6 tie in bin 0 and row 133 with them in bin 1; row 6 is
    deleted. Query 0 (equal to row 6) probing partition 0 (rows 0-199, one
    padded window from row 0) gets row 5 at round 0 of bin 0 (column 0) and
    row 133 at round 0 of bin 1 (column 1), distance 0 each."""
    lay = BitLayout(seed=3)
    got_d, got_i = probe.grouped_probe_nofold(*lay.torch_args(), lay.w_pad, 8)
    pair = int(np.nonzero(np.asarray(lay.order) == 0)[0][0])
    assert got_i[pair, :2].tolist() == [5, 133] and got_d[pair, :2].tolist() == [0.0, 0.0]
    assert 6 not in got_i[pair].tolist()


@pytest.mark.parametrize("k,bin_m", [(10, 4), (10, 10), (3, 3)])
def test_grouped_b1_plain_matches_pallas(k, bin_m):
    """B3 over packed rows with hamming (B4): the [P, k] distances and ids
    of the TPU kernel's bit-plane product, bit for bit."""
    lay = BitLayout(seed=10 + k + bin_m)
    want_d, want_i = lay.grouped(k, bin_m)
    mt, q_g, q_sq, t, pop_t, pen, _, start, ln = lay.torch_args()
    got_d, got_i = probe.grouped_probe(mt, q_g, q_sq, t, pop_t, pen, start, ln, k, bin_m)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # true hamming distances
    bits_q = np.unpackbits(q_g.numpy(), axis=1).astype(np.int32)
    bits_t = np.unpackbits(lay.t, axis=1).astype(np.int32)
    found = np.nonzero(got_i.numpy() >= 0)
    rows = got_i.numpy()[found]
    np.testing.assert_array_equal(got_d.numpy()[found], np.abs(bits_q[found[0]] - bits_t[rows]).sum(axis=1))


def test_binary_pairs_match_reference():
    """The pair list over packed query rows equals the JAX package's."""
    lay = BitLayout(nq=50, nprobe=5, seed=4)
    q_g, qid_s, st_c, off, ln, order, p0, p_total = ivf._binned_pairs(
        torch.from_numpy(lay.q), torch.from_numpy(lay.probes), torch.from_numpy(lay.starts),
        torch.from_numpy(lay.lens), lay.cap2, lay.w_pad, lay.nprobe)
    assert (p0, p_total) == (lay.p0, lay.p_total)
    np.testing.assert_array_equal(q_g.numpy(), np.asarray(lay.q_g))
    for got, ref in zip((st_c, off, ln), lay.pair_windows()):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_probe_wrappers_check_their_arguments():
    """hamming goes with uint8 rows and they with it; B5 takes hamming
    only and a 128-multiple w_pad within the table; a required operand
    that is None raises before any launch; a window outside its padded
    window finds nothing."""
    lay = BitLayout(nq=8, seed=5)
    args = list(lay.torch_args())
    with pytest.raises(TypeError):
        probe.grouped_probe(MetricKind.L2sq, *args[1:6], args[7], args[8], 10, 4)
    i8 = [a.to(torch.int8) if isinstance(a, torch.Tensor) and a.dtype == torch.uint8 else a for a in args]
    with pytest.raises(TypeError):
        probe.grouped_probe(MetricKind.Hamming, *i8[1:6], i8[7], i8[8], 10, 4)
    for w_pad in (100, 0, lay.cap2 + 128):
        with pytest.raises(ValueError):
            probe.grouped_probe_nofold(*args, w_pad, 8)
    with pytest.raises(TypeError):
        probe.grouped_probe_nofold(MetricKind.L2sq, *args[1:], lay.w_pad, 8)
    for i in (2, 6, 7, 8):  # q_sq, win_base, win_start, win_len
        wrong = list(args)
        wrong[i] = None
        with pytest.raises(ValueError):
            probe.grouped_probe_nofold(*wrong, lay.w_pad, 8)
    with pytest.raises(ValueError):
        probe.grouped_probe(*args[:2], None, *args[3:6], args[7], args[8], 10, 4)
    shifted = list(args)
    shifted[6] = args[6] + 128  # the window now starts before its padded window
    d, i = probe.grouped_probe_nofold(*shifted, lay.w_pad, 8)
    live = (args[8] > 0) & (args[7] < args[6] + 128)
    assert live.any() and (i[live] == -1).all() and (d[live] == MASKED).all()
