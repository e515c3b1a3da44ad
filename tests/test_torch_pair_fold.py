"""Kernel B6 (the per-query ``pair`` probe) as the card runs it, through
plain versions on the CPU: the (query, window) pairs sorted into cells of
128 (`pair_cells`), B3 over them with each pair's list kept in rank form
(`grouped_probe_plain(..., rank_form=True)`, what csrc/probe.cu
``usearch_pair_lists`` computes), and the fold of each query's lists in
window order (`pair_fold_plain`, csrc/pair.cu ``usearch_pair_fold``). The
three together must equal B6's plain version `pair_probe_plain` and the
TPU kernel `pallas_ivf_probe` (`_make_probe_kernel`) in Pallas interpret
mode.

Tolerances are test_torch_pair.py's: against B6's plain version i8 and b1
bit for bit (the same integer dots, the same f32 arithmetic), bf16 and f32
within rtol 1e-5 (B3's plain version multiplies a window's pairs at once,
B6's each query alone: f32 sums in another order); against the reference
`assert_probe_equal`'s rules."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_nofold import BitLayout  # noqa: E402
from test_torch_pair import jax_pair, numeric_t_aux, pair_windows, planted  # noqa: E402
from test_torch_probe import Layout, assert_probe_equal  # noqa: E402

from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402


def decomposed(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k, w_pad, bin_m):
    """B6 in its three steps, each through its plain version."""
    qid, win_start, win_len, inv = probe.pair_cells(starts, offs, lens, table.shape[0], w_pad)
    assert win_start.shape[0] % probe.LANES == 0 and win_start.dtype == win_len.dtype == inv.dtype == torch.int32
    lists_d, lists_i = probe.grouped_probe_plain(metric, q[qid].contiguous(), q_sq[qid].contiguous(), table, t_sq,
                                                 penalty, win_start, win_len, k, min(bin_m, k), rank_form=True)
    return probe.pair_fold_plain(metric, lists_d, lists_i, inv, q_sq, k)


def both(metric, lay, k, bin_m, windows=None, penalty=True, t_sq=None, q=None, q_sq=None, table=None):
    """(decomposed, B6's plain version) over ``lay``'s tensors."""
    windows = tuple(torch.from_numpy(x) for x in (windows or pair_windows(lay)))
    args = (MetricKind(metric), lay.tq if q is None else q, torch.from_numpy(lay.q_sq) if q_sq is None else q_sq,
            lay.tt if table is None else table,
            (None if metric == "ip" else torch.from_numpy(lay.t_sq)) if t_sq is None else t_sq,
            torch.from_numpy(lay.penalty) if penalty else None, *windows, k, lay.w_pad, bin_m)
    got = tuple(x.numpy() for x in decomposed(*args))
    want = tuple(x.numpy() for x in probe.pair_probe_plain(*args))
    return got, want


def assert_same(got, want, dtype):
    """The decomposition against B6's plain version (module docstring)."""
    if dtype in ("i8", "b1"):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert_probe_equal(got, want, dtype, "l2sq")


@pytest.mark.parametrize("dtype,metric", [(d, m) for d in ("i8", "bf16", "f32") for m in ("ip", "cos", "l2sq")])
def test_decomposition_matches_pair_and_pallas(dtype, metric):
    """k = 10 at 4 per bin, 16 queries of 4 probes; planted ties inside a
    bin and across bins (rows 5, 6, 133), ~10% deleted rows, a zero row."""
    lay = Layout(dtype, nq=16, seed=60)
    got, want = both(metric, lay, 10, 4)
    assert_same(got, want, dtype)
    ref = jax_pair(metric, lay.jq, lay.jt, numeric_t_aux(lay, metric), lay, 10, 4)
    assert_probe_equal(got, ref, dtype, metric)
    assert not np.isin(np.nonzero(~lay.valid)[0], got[1]).any()


@pytest.mark.parametrize("bin_m", [4, 10])
def test_decomposition_b1_hamming(bin_m):
    """Packed 1024-bit rows with hamming (B4's product in B6's lists), bit
    for bit against both: pervasive integer ties."""
    lay = BitLayout(nq=16, seed=61 + bin_m)
    q_sq = torch.from_numpy(np.unpackbits(lay.q, axis=1).sum(axis=1).astype(np.float32))
    got, want = both("hamming", lay, 10, bin_m, q=torch.from_numpy(lay.q), q_sq=q_sq, table=torch.from_numpy(lay.t),
                     t_sq=torch.from_numpy(lay.pop_t))
    assert_same(got, want, "b1")
    t_aux = np.stack([lay.pop_t, np.zeros_like(lay.pop_t), lay.penalty, np.zeros_like(lay.penalty)])
    ref = jax_pair("hamming", jnp.asarray(lay.q), jnp.asarray(lay.t), t_aux, lay, 10, bin_m)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("dtype,metric", [("i8", "ip"), ("f32", "l2sq")])
def test_decomposition_without_penalty(dtype, metric):
    """No penalty row (every row live): against the reference with a zero
    penalty."""
    lay = Layout(dtype, nq=16, seed=62)
    lay.valid[:] = True
    lay.penalty[:] = 0.0
    got, want = both(metric, lay, 10, 4, penalty=False)
    assert_same(got, want, dtype)
    assert_probe_equal(got, jax_pair(metric, lay.jq, lay.jt, numeric_t_aux(lay, metric), lay, 10, 4), dtype, metric)


@pytest.mark.parametrize("bin_m", [1, 4, 32, 64])
def test_decomposition_bin_m_at_k_64(bin_m):
    """k = 64 with 1, 4, 32 and k candidates per bin: past the 16 that
    one pass of B3's lists takes, B6's lists run passes."""
    lay = Layout("i8", nq=8, nprobe=3, seed=63)
    got, want = both("l2sq", lay, 64, bin_m)
    assert_same(got, want, "i8")
    assert_probe_equal(got, jax_pair("l2sq", lay.jq, lay.jt, numeric_t_aux(lay, "l2sq"), lay, 64, bin_m), "i8", "l2sq")


def test_duplicate_and_invalid_windows():
    """A query probing one window twice, every query probing window 0
    (many pairs of one window), and windows the pair flavour skips: a start
    past the table, a start off the 128-row grid, an offset that pushes the
    window past its padded window, a negative length."""
    lay = Layout("i8", nq=16, seed=64)
    lay.probes[:, 0] = 0
    lay.probes[3, 1] = lay.probes[3, 2]
    st_c, off, ln = (x.copy() for x in pair_windows(lay))
    got, want = both("l2sq", lay, 10, 4, windows=(st_c, off, ln))
    assert_same(got, want, "i8")
    assert_probe_equal(got, jax_pair("l2sq", lay.jq, lay.jt, numeric_t_aux(lay, "l2sq"), lay, 10, 4), "i8", "l2sq")
    st_c[4, 1] = lay.cap2
    st_c[5, 2] += 1
    off[6, 3] = lay.w_pad - ln[6, 3] + 1
    ln[7, 0] = -3
    got, want = both("l2sq", lay, 10, 4, windows=(st_c, off, ln))
    assert_same(got, want, "i8")
    _, _, win_len, inv = probe.pair_cells(*(torch.from_numpy(x) for x in (st_c, off, ln)), lay.cap2, lay.w_pad)
    skipped = win_len[inv.long()].numpy()
    assert skipped[4, 1] == skipped[5, 2] == skipped[6, 3] == skipped[7, 0] == 0


@pytest.mark.parametrize("probes,first", [([2, 0, 1, 3], [300, 5, 133, 6]), ([0, 2, 1, 3], [5, 133, 6, 300])])
def test_fold_keeps_window_round_bin_order(probes, first):
    """Equal distances across windows (row 300 of partition 2), across bins
    (row 133) and inside a bin (rows 5 and 6): (window, round, bin)."""
    lay = planted(probes)
    got, want = both("l2sq", lay, 10, 4)
    assert_same(got, want, "i8")
    assert got[1][0][:4].tolist() == first and got[0][0][:4].tolist() == [0.0] * 4
    assert_probe_equal(got, jax_pair("l2sq", lay.jq, lay.jt, numeric_t_aux(lay, "l2sq"), lay, 10, 4), "i8", "l2sq")


def test_fold_orders_by_rank_value_where_the_epilogue_merges():
    """cos: rows A (dot 1e-9) in the query's first window and B (dot 2e-9)
    in its second both end at distance 1.0 after the epilogue (1 - 2e-9
    rounds to 1 in f32), but B ranks first (-2e-9 < -1e-9). The fold
    compares rank values: B, then A, where a fold over the distances would
    put A first."""
    lay = Layout("f32", nq=8, seed=65)
    t, q = np.asarray(lay.jt).copy(), np.asarray(lay.jq).copy()
    t[:, 0] = -np.abs(t[:, 0]) - 1.0  # every other row ranks after them
    q[0] = 0.0
    q[0, 0] = 1.0
    lay.probes[0] = [0, 2, 1, 3]
    a, b = int(lay.starts[0]) + 10, int(lay.starts[2]) + 10
    for row, dot in ((a, 1e-9), (b, 2e-9)):
        t[row] = 0.0
        t[row, 0], t[row, 1] = dot, 1.0
    lay.valid[[a, b]] = True
    lay.penalty[[a, b]] = 0.0
    lay.jt, lay.jq = jnp.asarray(t), jnp.asarray(q)
    lay.tt, lay.tq = torch.from_numpy(t), torch.from_numpy(q)
    lay.t_sq, lay.t_sum = (t * t).sum(axis=1, dtype=np.float32), t.sum(axis=1, dtype=np.float32)
    lay.q_sq = (q * q).sum(axis=1, dtype=np.float32)
    got, want = both("cos", lay, 10, 4)
    assert got[1][0][:2].tolist() == want[1][0][:2].tolist() == [b, a] and got[0][0][:2].tolist() == [1.0, 1.0]
    assert_same(got, want, "f32")
    ref = jax_pair("cos", lay.jq, lay.jt, numeric_t_aux(lay, "cos"), lay, 10, 4)
    assert ref[1][0][:2].tolist() == [b, a]


def test_pair_cells_sort_pad_and_invert():
    """The pairs are sorted by the window's first row (empty windows last),
    stably (a window's pairs in query order), padded to cells of 128 with
    empty pairs, and `inv` maps each (query, window) to its pair."""
    lay = Layout("i8", nq=40, seed=66)
    st_c, off, ln = (torch.from_numpy(x) for x in pair_windows(lay))
    qid, win_start, win_len, inv = probe.pair_cells(st_c, off, ln, lay.cap2, lay.w_pad)
    n_q, nprobe = st_c.shape
    assert win_start.shape[0] == -(-n_q * nprobe // 128) * 128 and (win_len[n_q * nprobe :] == 0).all()
    live = win_len[: n_q * nprobe] > 0
    first = torch.where(live, win_start[: n_q * nprobe], lay.cap2).long()
    assert (first[1:] >= first[:-1]).all()
    ties = first[1:] == first[:-1]
    assert (qid[1 : n_q * nprobe][ties] >= qid[: n_q * nprobe - 1][ties]).all()
    flat = inv.long().reshape(-1)
    assert torch.equal(torch.sort(flat)[0], torch.arange(n_q * nprobe))
    assert torch.equal(qid[flat], torch.arange(n_q * nprobe) // nprobe)
    want_start = (st_c + off).reshape(-1)
    assert torch.equal(torch.where(win_len[flat] > 0, win_start[flat], -1),
                       torch.where(ln.reshape(-1) > 0, want_start, -1))


def test_fold_plain_pads_with_masked():
    """Fewer entries than k over all windows: the rest MASKED with id -1;
    lists past their end (MASKED, -1) give nothing."""
    lists_d = torch.tensor([[1.0, 3.0, MASKED], [2.0, MASKED, MASKED]])
    lists_i = torch.tensor([[10, 30, -1], [20, -1, -1]], dtype=torch.int32)
    inv = torch.tensor([[1, 0]], dtype=torch.int32)
    d, i = probe.pair_fold_plain(MetricKind.IP, lists_d, lists_i, inv, torch.ones(1), 4)
    assert d.tolist() == [[1.0, 2.0, 3.0, float(np.float32(MASKED))]] and i.tolist() == [[10, 20, 30, -1]]
