"""The exact rescore (`ops/scan.block_dots`, csrc/rescore.cu on the card)
against the JAX package's, on the CPU.

- `block_dots_plain` against `pallas_search_exact`'s product
  (usearch_tpu/ops/pallas_scan.py:794-800): `jax.lax.dot_general` of each
  query with its gathered bins' rows, i8 into int32, f32 at HIGHEST, bf16
  into f32. i8 dots are equal (integers, W=256 and W=1,152, past
  ``I8_F32_EXACT_WIDTH``); bf16 and f32 dots are sums of the same W terms
  in another order, each within W 2^-24 of the terms' absolute sum of the
  exact dot, so within twice that of each other (bf16 products are exact in
  f32; f32 products round once more, hence W + 1).
- A numpy model of the kernel's layout (16 teams of 8 lanes, 8 rows a
  team, a lane's 16-byte chunks l, l + 8, ..., a reduce-scatter of xor
  shuffles) equal to `block_dots_plain` on i8, where the sums are exact.
- `search_exact` (B2's plain version, the bin top-k, the rescore)
  against `pallas_search_exact(..., interpret=True)`: ids equal apart from
  ties, i8 distances bit for bit (W=1,152 too), float distances within
  rtol 1e-5; ~10% of the rows masked, the queries planted on the table's
  last bin, k 10 and 32, Q=44 (a multiple of neither plain chunk).
- `exact_steps` yields after B2 and after the rescore; a two-shard
  `ShardedIndex`'s exact search through them equals the single index's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops import pallas_scan as jscan  # noqa: E402
from usearch_tpu.ops.distances import row_stats as j_row_stats  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402
from usearch_torch.parallel.mesh import make_mesh  # noqa: E402
from usearch_torch.parallel.sharded import ShardedIndex  # noqa: E402

_JAX = {"i8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}
_TORCH = {"i8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
RTOL = 1e-5


def rows(rng, dtype: str, n: int, w: int) -> np.ndarray:
    """Random rows: i8 integers, or normal f32 (bf16 rounds them)."""
    if dtype == "i8":
        return rng.integers(-127, 128, (n, w)).astype(np.int8)
    return rng.standard_normal((n, w)).astype(np.float32)


def both(x: np.ndarray, dtype: str):
    return jnp.asarray(x, _JAX[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


def jax_dots(jq, jt, bins: np.ndarray):
    """`one_chunk`'s product in pallas_search_exact, on the same gathered
    rows: [Q, b * 128]."""
    n_q, b = bins.shape
    w = jt.shape[1]
    gathered = jt.reshape(-1, 128, w)[jnp.asarray(bins)].reshape(n_q, b * 128, w)
    bdims = (((1,), (2,)), ((0,), (0,)))
    if jq.dtype == jnp.int8:
        return jax.lax.dot_general(jq, gathered, bdims, preferred_element_type=jnp.int32)
    if jq.dtype == jnp.float32:
        return jax.lax.dot_general(jq, gathered, bdims, precision=jax.lax.Precision.HIGHEST)
    return jax.lax.dot_general(jq, gathered, bdims, preferred_element_type=jnp.float32)


def bins_with_edges(rng, n_q: int, b: int, n_bins: int) -> np.ndarray:
    """Random bins, with the table's last bin and a bin repeated in one
    query's list."""
    bins = rng.integers(0, n_bins, (n_q, b))
    bins[:, -1] = n_bins - 1
    bins[0, :] = bins[0, 0]
    return bins


@pytest.mark.parametrize("dtype,w", [("i8", 256), ("i8", 1152), ("bf16", 256), ("f32", 256)])
def test_block_dots_plain_matches_dot_general(dtype, w):
    rng = np.random.default_rng(w + len(dtype))
    n, n_q, b = 4096, 40, 14
    t, q = rows(rng, dtype, n, w), rows(rng, dtype, n_q, w)
    (jt, tt), (jq, tq) = both(t, dtype), both(q, dtype)
    bins = bins_with_edges(rng, n_q, b, n // 128)
    got = scan.block_dots_plain(tq, tt, torch.from_numpy(bins))
    want = np.asarray(jax_dots(jq, jt, bins))
    assert got.shape == (n_q, b * 128)
    if dtype == "i8":
        assert got.dtype == (torch.float64 if w > scan.I8_F32_EXACT_WIDTH else torch.float32)
        np.testing.assert_array_equal(got.double().numpy(), want.astype(np.float64))
        return
    # the terms' absolute sums, from the operands as stored
    tf, qf = tt.float().numpy(), tq.float().numpy()
    gathered = tf.reshape(-1, 128, w)[bins].reshape(n_q, b * 128, w)
    terms = np.einsum("qrw,qw->qr", np.abs(gathered).astype(np.float64), np.abs(qf).astype(np.float64))
    bound = 2 * (w + 1) * 2.0**-24 * terms
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= bound)


def kernel_model(q: np.ndarray, table: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """csrc/rescore.cu's arithmetic over i8 rows in numpy: per (query, bin)
    lane l of team t sums, for each of its rows 8 t + r, the products of its
    16-byte chunks c = 8 s + l; the team's reduce-scatter (xor shuffles of
    distance 4, 2, 1, each lane keeping the half of its rows on its side of
    that bit) leaves lane l with row 8 t + l's dot."""
    n_q, b = bins.shape
    w = table.shape[1]
    chunks = w // 16
    out = np.zeros((n_q, b * 128), dtype=np.int64)
    for i in range(n_q):
        qc = q[i].astype(np.int64).reshape(chunks // 8, 8, 16)  # [s, l, e]
        for j in range(b):
            blk = table[bins[i, j] * 128 : (bins[i, j] + 1) * 128].astype(np.int64)
            blk = blk.reshape(16, 8, chunks // 8, 8, 16)  # [team, r, s, l, e]
            acc = np.einsum("trsle,sle->tlr", blk, qc)  # [team, lane, rows held]
            h = 4
            while h >= 1:
                upper = (np.arange(8) & h) != 0
                lo, hi = acc[:, :, :h], acc[:, :, h : 2 * h]
                send = np.where(upper[None, :, None], lo, hi)
                keep = np.where(upper[None, :, None], hi, lo)
                acc = keep + send[:, np.arange(8) ^ h, :]
                h //= 2
            out[i, j * 128 : (j + 1) * 128] = acc[:, :, 0].reshape(128)
    return out


@pytest.mark.parametrize("w", [128, 384])
def test_kernel_layout_model_matches_plain(w):
    rng = np.random.default_rng(w)
    n, n_q, b = 2048, 6, 5
    t, q = rows(rng, "i8", n, w), rows(rng, "i8", n_q, w)
    bins = bins_with_edges(rng, n_q, b, n // 128)
    want = scan.block_dots_plain(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(bins))
    np.testing.assert_array_equal(kernel_model(q, t, bins), want.numpy().astype(np.int64))


def test_block_dots_checks_its_operands():
    t, q = torch.zeros(1024, 128, dtype=torch.int8), torch.zeros(4, 128, dtype=torch.int8)
    bins = torch.zeros(4, 3, dtype=torch.int64)
    assert scan.block_dots(q, t, bins).shape == (4, 384)
    with pytest.raises(ValueError):
        scan.block_dots(q, t, bins.int())
    with pytest.raises(TypeError):
        scan.block_dots(q.float(), t, bins)
    with pytest.raises(ValueError):
        scan.block_dots(q, t[:1000], bins)
    with pytest.raises(ValueError):
        scan.block_dots(torch.zeros(4, 1 << 17, dtype=torch.int8), torch.zeros(128, 1 << 17, dtype=torch.int8),
                        bins)


class Case:
    """A table and queries in both packages: ~10% of the rows masked (the
    last bin's first rows among them), the first queries planted on rows of
    the table's last bin."""

    def __init__(self, dtype: str, n: int, n_q: int, w: int, seed: int):
        rng = np.random.default_rng(seed)
        t, q = rows(rng, dtype, n, w), rows(rng, dtype, n_q, w)
        q[:4] = t[[n - 1, n - 2, n - 64, n - 128]]
        self.valid = rng.random(n) >= 0.1
        self.valid[n - 128 : n - 120] = False
        (self.jt, self.tt), (self.jq, self.tq) = both(t, dtype), both(q, dtype)
        self.stats = np.array(j_row_stats(self.jt, usearch_tpu.ScalarKind(dtype)))


def sorted_results(d, i):
    d, i = np.asarray(d), np.asarray(i)
    order = np.lexsort((i, d), axis=1)
    return np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1)


def assert_same_apart_from_ties(got, want, exact: bool):
    gd, gi = sorted_results(*got)
    wd, wi = sorted_results(*want)
    if exact:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-6)
    differ = gi != wi
    np.testing.assert_allclose(gd[differ], wd[differ], rtol=RTOL, atol=1e-6)


EXACT_CASES = [("i8", 1152, "ip", 10), ("i8", 1152, "cos", 32), ("i8", 1152, "l2sq", 10), ("i8", 256, "l2sq", 32),
               ("bf16", 256, "cos", 10), ("f32", 256, "l2sq", 32), ("f32", 256, "ip", 10)]


@pytest.mark.parametrize("dtype,w,metric,k", EXACT_CASES)
def test_search_exact_matches_pallas(dtype, w, metric, k):
    n, n_q = 8192, 44
    c = Case(dtype, n, n_q, w, seed=w + k)
    want = jscan.pallas_search_exact(JMetric(metric), c.jq, c.jt, c.stats, jnp.asarray(c.valid), k,
                                     q_tile=n_q, t_tile=2048, interpret=True)
    got = scan.search_exact(MetricKind(metric), c.tq, c.tt, torch.from_numpy(c.stats), torch.from_numpy(c.valid), k)
    assert got[0].shape == (n_q, k)
    assert_same_apart_from_ties(got, want, exact=dtype == "i8")
    # the planted queries find their own rows in the last bin, masked or not
    last = got[1][:4].numpy()
    assert np.all((last >= 0) & (last < n))
    assert not np.isin(np.flatnonzero(~c.valid), got[1].numpy()).any()


def test_exact_steps_yield_after_b2_and_after_the_rescore(monkeypatch):
    c = Case("i8", 2048, 20, 128, seed=1)
    stats, valid = torch.from_numpy(c.stats), torch.from_numpy(c.valid)
    calls = []
    plain = scan.block_dots_plain
    monkeypatch.setattr(scan, "block_dots_plain", lambda *a: (calls.append(a[2].shape), plain(*a))[1])
    steps = scan.exact_steps(MetricKind.L2sq, c.tq, c.tt, stats, valid, 10)
    next(steps)
    assert calls == []  # B2 and its bin top-k, no rescore yet
    next(steps)
    assert calls == [(20, 14)]
    with pytest.raises(StopIteration) as done:
        next(steps)
    d, i = done.value.value
    want = scan.search_exact(MetricKind.L2sq, c.tq, c.tt, stats, valid, 10)
    assert torch.equal(d, want[0]) and torch.equal(i, want[1])


@pytest.mark.parametrize("metric", ["ip", "l2sq"])
def test_two_shards_match_the_single_index(metric, monkeypatch):
    """Two shards of 1,536 i8 rows take B2's route and the rescore (their
    plain versions here) a shard each; keys equal to the single index's
    apart from ties, distances bit for bit."""
    rng = np.random.default_rng(5)
    data = rng.integers(-100, 101, (3072, 128)).astype(np.int8)
    queries = data[rng.choice(3072, 24, replace=False)]
    single = usearch_torch.Index(ndim=128, metric=metric, dtype="i8", device="cpu")
    single.add(None, data)
    want = single.search(queries, 10, exact=True)
    calls = []
    plain = scan.block_dots_plain
    monkeypatch.setattr(scan, "block_dots_plain", lambda *a: (calls.append(a[1].shape[0]), plain(*a))[1])
    pool = ShardedIndex.build(data, metric=metric, dtype="i8", mesh=make_mesh(2, device="cpu"))
    got = pool.search(queries, 10, exact=True)
    assert calls == [1536, 1536]
    assert_same_apart_from_ties((got.distances, got.keys.astype(np.int64)),
                                (want.distances, want.keys.astype(np.int64)), exact=True)
