"""The flat-index slice end to end: the same data in a usearch_tpu.Index and
a usearch_torch.Index (by `add`, and carried across by
`convert.index_from_arrays`) answers the same queries.

The JAX index is switched to its Pallas kernels (interpret mode on the CPU),
so both packages take the binned-kernel path; its default on the CPU is an
XLA scan with another approximation."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch.convert import index_from_arrays  # noqa: E402

RTOL = 1e-5


@pytest.fixture
def pallas_backend():
    jexact.set_kernel_backend("pallas")
    try:
        yield
    finally:
        jexact.set_kernel_backend("auto")


def jax_state(ix) -> dict:
    """The JAX index's state as numpy arrays."""
    return dict(
        table=np.asarray(ix._table), stats=np.asarray(ix._stats), valid=np.asarray(ix._valid),
        slot_keys=np.asarray(ix._slot_keys), count=ix._count, next_slot=ix._next_slot,
        free_slots=list(ix._free_slots), ndim=ix.ndim, metric=ix.metric.value,
        dtype=ix.dtype.value, multi=ix.multi,
    )


def data(dtype, n, ndim, seed):
    rng = np.random.default_rng(seed)
    if dtype == "i8":  # i8 rows are stored verbatim by both: no quantizer in the way
        return rng.integers(-127, 128, (n, ndim)).astype(np.int8)
    x = rng.standard_normal((n, ndim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def build_pair(dtype, metric, n, ndim, seed, removed=0):
    ref = usearch_tpu.Index(ndim=ndim, metric=metric, dtype=dtype)
    port = usearch_torch.Index(ndim=ndim, metric=metric, dtype=dtype, device="cpu")
    x = data(dtype, n, ndim, seed)
    keys = np.arange(n, dtype=np.uint64) + 1000
    ref.add(keys, x)
    port.add(keys, x)
    if removed:
        gone = keys[np.random.default_rng(seed + 1).choice(n, removed, replace=False)]
        ref.remove(gone)
        port.remove(gone)
    return ref, port, x


def assert_same(got, want, exact_dists: bool, atol: float = 1e-6):
    """Keys equal apart from ties; distances exact or within RTOL."""
    assert got.keys.shape == want.keys.shape
    np.testing.assert_array_equal(got.counts, want.counts)
    gd, wd = np.sort(got.distances, axis=1), np.sort(want.distances, axis=1)
    if exact_dists:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=atol)
    for row in range(got.keys.shape[0]):
        missing = set(want.keys[row].tolist()) - set(got.keys[row].tolist())
        if missing:  # only keys tied with the k-th distance may differ
            kth = want.distances[row].max()
            wd_of = dict(zip(want.keys[row].tolist(), want.distances[row].tolist()))
            assert all(abs(wd_of[k] - kth) <= RTOL * abs(kth) + atol for k in missing)


@pytest.mark.parametrize("dtype", ["i8", "bf16", "f32"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2sq"])
def test_exact_search_parity(pallas_backend, dtype, metric):
    """exact=True through kernel B2 on both sides, by add and by state."""
    ref, port, x = build_pair(dtype, metric, 3000, 96, seed=1, removed=300)
    carried = index_from_arrays(jax_state(ref), device="cpu")
    assert torch.equal(port._table, carried._table) or dtype == "f32"
    q = x[::150]
    want = ref.search(q, 10, exact=True)
    for ix in (port, carried):
        got = ix.search(q, 10, exact=True)
        assert_same(got, want, exact_dists=dtype == "i8")


@pytest.mark.parametrize("dtype,metric", [("i8", "ip"), ("bf16", "cos"), ("f32", "l2sq")])
def test_approximate_search_parity(pallas_backend, dtype, metric):
    """The approximate path at 131,072 rows: kernel B1 on both sides. i8
    and bf16 pick one candidate per bin and match id for id apart from
    ties; f32 ranks bins on bf16 and rescores, so it is held to the
    reference's recall@10 less 0.005."""
    ref, port, x = build_pair(dtype, metric, 131072, 128, seed=2, removed=1000)
    carried = index_from_arrays(jax_state(ref), device="cpu")
    q = x[np.random.default_rng(3).choice(131072, 16, replace=False)]
    want = ref.search(q, 10)
    truth = ref.search(q, 10, exact=True).keys
    for ix in (port, carried):
        got = ix.search(q, 10)
        if dtype == "f32":
            recall = lambda m: np.mean([len(set(a) & set(b)) / 10 for a, b in zip(m.keys, truth)])
            assert recall(got) >= recall(want) - 0.005
        else:
            assert_same(got, want, exact_dists=dtype == "i8")


def test_index_from_arrays_carries_state(pallas_backend):
    """Deletions, free slots, multi keys and counts come across."""
    ref = usearch_tpu.Index(ndim=16, metric="cos", dtype="bf16", multi=True)
    x = data("f32", 200, 16, seed=4)
    ref.add(np.repeat(np.arange(100, dtype=np.uint64), 2), x)
    ref.remove([3, 7])
    port = index_from_arrays(jax_state(ref), device="cpu")
    assert len(port) == len(ref) == 196 and port.multi and port.capacity == ref.capacity
    assert port.count(5) == 2 and not port.contains(3)
    np.testing.assert_array_equal(port._table.view(torch.int16).numpy(), np.asarray(ref._table).view(np.int16))
    np.testing.assert_allclose(np.vstack(port.get(5)), np.vstack(ref.get(5)), atol=0)
    port.add(np.array([500, 501], dtype=np.uint64), x[:2])  # reuses the newest freed slots
    assert port._keymap.slots_of(500) + port._keymap.slots_of(501) == list(ref._free_slots[-2:])
    assert_same(port.search(x[10:14], 4, exact=True), ref.search(x[10:14], 4, exact=True), exact_dists=False)
    with pytest.raises(KeyError):
        index_from_arrays({"table": np.zeros((8, 128), np.float32)}, device="cpu")
