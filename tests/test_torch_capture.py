"""Whole-search capture (usearch_torch/graphs.py) on the CPU.

On the card each search path in scope is captured once per key as a CUDA
graph and replayed after. Here a recording stand-in takes the capture's
place (`StandIn`): a capture runs the body once on the graph's static
inputs, a replay runs it again on them and writes the static outputs in
place, as a graph does. While a body runs inside the stand-in, a guard
(`HostReadGuard`) makes every host read a graph would refuse or freeze
raise: ``Tensor.item``, ``tolist``, ``__bool__``, ``__int__``,
``__float__``, ``cpu``, ``numpy``, ``torch.nonzero``, ``torch.unique``,
``torch.masked_select``, boolean-mask indexing, and tensors made from host
data (a host-to-device copy on the card). The kernel wrappers' plain
versions stand in for single launches and run unguarded.

Each body's replays equal the eager search bit for bit, and the JAX
package's search at the tolerances of the parity tests they come from
(test_torch_parity.py, test_torch_ivf.py, test_torch_binary_ivf.py,
test_torch_sharded.py); the JAX side runs its Pallas kernels in interpret
mode through ``set_kernel_backend("pallas")``. Then the cache itself: keys,
generations, LRU, the launch counts a replay adds (and
only the capturing thread's), replays of one pool from two threads, the
device's pool budget, profiler sessions, and a failed capture.
"""

import contextlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_binary_ivf import assert_same as assert_same_b1  # noqa: E402
from test_torch_binary_ivf import bit_corpus  # noqa: E402
from test_torch_binary_ivf import carried as carried_b1  # noqa: E402
from test_torch_ivf import assert_same as assert_same_ivf  # noqa: E402
from test_torch_ivf import carried, data  # noqa: E402
from test_torch_parity import assert_same as assert_same_flat  # noqa: E402
from test_torch_parity import jax_state  # noqa: E402
from test_torch_sharded import IVF_ATOL, blobs  # noqa: E402
from test_torch_sharded import assert_same as assert_same_sharded  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402
from usearch_tpu import ivf as jivf  # noqa: E402
from usearch_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from usearch_tpu.parallel.sharded import ShardedIndex as JaxSharded  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import graphs, ivf  # noqa: E402
from usearch_torch import index as index_mod  # noqa: E402
from usearch_torch.convert import index_from_arrays  # noqa: E402
from usearch_torch.exact import pad_queries  # noqa: E402
from usearch_torch.graphs import GraphCache  # noqa: E402
from usearch_torch.ops import probe, scan  # noqa: E402
from usearch_torch.parallel.mesh import make_mesh  # noqa: E402
from usearch_torch.parallel.sharded import ShardedIndex  # noqa: E402

#: the kernel wrappers whose plain versions stand in for one launch, by the
#: modules that call them
KERNELS = {scan: ("binned_scan", "binned_minima"), probe: ("grouped_probe", "grouped_probe_nofold"),
           ivf: ("grouped_probe", "grouped_probe_nofold", "binned_probe")}
#: Tensor methods that read a value to the host
READS = ("item", "tolist", "__bool__", "__int__", "__float__", "cpu", "numpy")
#: torch functions that read to the host or copy host data to the device
HOST_FNS = ("nonzero", "unique", "masked_select", "tensor", "as_tensor")


class HostReadGuard:
    """While `armed` (on this thread), every host read a captured body may
    not make raises; the kernel wrappers disarm it while they run."""

    def __init__(self, monkeypatch):
        self._local = threading.local()
        self.caught = []
        for name in READS:
            monkeypatch.setattr(torch.Tensor, name, self._guarded(name, getattr(torch.Tensor, name)))
        for name in HOST_FNS:
            monkeypatch.setattr(torch, name, self._guarded(f"torch.{name}", getattr(torch, name)))
        for name in ("__getitem__", "__setitem__"):
            monkeypatch.setattr(torch.Tensor, name, self._indexing(name, getattr(torch.Tensor, name)))
        for mod, names in KERNELS.items():
            for name in names:
                monkeypatch.setattr(mod, name, self._unguarded(getattr(mod, name)))

    @property
    def on(self) -> bool:
        return getattr(self._local, "on", False)

    @contextlib.contextmanager
    def armed(self, on: bool = True):
        was, self._local.on = self.on, on
        try:
            yield
        finally:
            self._local.on = was

    def _refuse(self, name):
        self.caught.append(name)
        raise AssertionError(f"{name} inside a captured body: a host read")

    def _guarded(self, name, fn):
        def wrapper(*args, **kwargs):
            if self.on:
                self._refuse(name)
            return fn(*args, **kwargs)

        return wrapper

    def _indexing(self, name, fn):
        def wrapper(t, idx, *rest):
            items = idx if isinstance(idx, tuple) else (idx,)
            if self.on and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items):
                self._refuse(f"boolean-mask {name}")
            return fn(t, idx, *rest)

        return wrapper

    def _unguarded(self, fn):
        def wrapper(*args, **kwargs):
            with self.armed(False):
                return fn(*args, **kwargs)

        return wrapper


class StandIn:
    """A recording stand-in for `graphs.CudaBackend`: a capture records the
    body and its static inputs and runs it under the guard; a replay runs
    it again, guarded, with its launches kept off the counters (the cache
    adds the recorded ones), and writes the static outputs in place. Its
    pool holds ``graph_bytes`` a graph until a reset."""

    def __init__(self, guard=None, graph_bytes: int = 0):
        self.guard = guard
        self.resets = 0
        self.graph_bytes, self.held = graph_bytes, 0

    def _armed(self):
        return contextlib.nullcontext() if self.guard is None else self.guard.armed()

    def reset(self):
        self.resets += 1
        self.held = 0

    def warm(self, body, args):
        return body(*args)

    def capture(self, body, args, generators=()):
        with self._armed():
            outputs = body(*args)
        self.held += 1
        return [body, args, outputs], outputs

    def replaying(self):
        return contextlib.nullcontext()

    def replay(self, graph):
        body, args, outputs = graph
        with self._armed(), graphs.recording():
            fresh = body(*args)
        for o, f in zip(outputs, fresh):
            o.copy_(f)

    def pool_bytes(self):
        return self.graph_bytes * self.held


@pytest.fixture
def guard(monkeypatch):
    return HostReadGuard(monkeypatch)


@pytest.fixture
def pallas_backend():
    jexact.set_kernel_backend("pallas")
    try:
        yield
    finally:
        jexact.set_kernel_backend("auto")


def cache_on(target, guard, **kwargs) -> GraphCache:
    """A stand-in cache in place of the card's: an `Index`'s, or each CPU
    device's of a `ShardedIndex`."""
    cache = GraphCache("cpu", backend=StandIn(guard), **kwargs)
    if isinstance(target, ShardedIndex):
        target._graphs = {dev: cache for dev in target.mesh.devices}
    else:
        target._graphs = cache
    return cache


@contextlib.contextmanager
def eager(target):
    saved, target._graphs = target._graphs, None if not isinstance(target, ShardedIndex) else {}
    try:
        yield
    finally:
        target._graphs = saved


def assert_bits(got, want):
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.distances.view(np.uint32), want.distances.view(np.uint32))
    np.testing.assert_array_equal(got.counts, want.counts)


def replays_equal_eager(target, batches, k, **kwargs):
    """Each batch through the stand-in's graphs (the first of a key
    captures, the rest replay) bit for bit the eager search's; the
    results."""
    got = [target.search(b, k, **kwargs) for b in batches]
    with eager(target):
        want = [target.search(b, k, **kwargs) for b in batches]
    for g, w in zip(got, want):
        assert_bits(g, w)
    return got


def test_guard_refuses_each_host_read(guard):
    t = torch.arange(6, dtype=torch.float32)
    reads = [lambda: t.item() if t.numel() == 1 else t[:1].item(), t.tolist, lambda: bool(t[0]), lambda: int(t[0]),
             lambda: float(t[0]), t.cpu, t.numpy, lambda: torch.nonzero(t), lambda: torch.unique(t),
             lambda: torch.masked_select(t, t > 2), lambda: t[t > 2], lambda: t.__setitem__(t > 2, 0.0),
             lambda: torch.tensor([1.0]), lambda: torch.as_tensor(np.ones(2))]
    for read in reads:
        with guard.armed(), pytest.raises(AssertionError, match="host read"):
            read()
    assert len(guard.caught) == len(reads)
    with guard.armed():
        assert scan.binned_minima.__name__ == "wrapper"  # the kernels run unguarded
    t.tolist()  # disarmed: as before


def test_flat_approximate_b1(pallas_backend, guard, monkeypatch):
    """B1 over i8 (one candidate per bin, `topk_min`): replays equal eager,
    and the JAX package's `search_kernel(approx=True)` id for id with equal
    distances apart from ties."""
    monkeypatch.setattr(index_mod, "APPROX_MIN_ROWS", 1000)
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (3000, 128)).astype(np.int8)  # 3,072 slots: B1's tiles of 1,024
    ref = usearch_tpu.Index(ndim=128, metric="ip", dtype="i8")
    ref.add(np.arange(3000, dtype=np.uint64) + 7, x)
    ref.remove(np.arange(40, dtype=np.uint64) * 3 + 7)
    port = index_from_arrays(jax_state(ref), device="cpu")
    cache = cache_on(port, guard)
    batches = [x[rng.choice(3000, 6, replace=False)] for _ in range(3)]
    got = replays_equal_eager(port, batches, 10)
    assert cache.captures == 1 and cache.replays == 2 and cache.keys()[0][:2] == ("flat", True)
    for b, g in zip(batches, got):
        q = port._padded_queries(port._prepare_host(b, port._kind)).numpy()
        d, i = jexact.search_kernel(ref.metric, ref.dtype, jnp.asarray(q), ref._table, ref._stats, ref._valid,
                                    ref.ndim, 10, 1024, approx=True)
        d, i = np.asarray(d)[: len(b)], np.asarray(i)[: len(b)]
        want = usearch_torch.BatchMatches(keys=np.where(i >= 0, np.asarray(ref._slot_keys)[np.clip(i, 0, None)], 0),
                                          distances=d, counts=np.sum(i >= 0, axis=1).astype(np.uint64))
        assert_same_flat(g, want, exact_dists=True)


def test_flat_compact_rescore(pallas_backend, guard, monkeypatch):
    """B1 compact over f32 cos (`rescore_exact` of 2k bins): replays equal
    eager, recall@10 no more than 0.005 below the JAX package's."""
    monkeypatch.setattr(index_mod, "APPROX_MIN_ROWS", 1000)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    ref = usearch_tpu.Index(ndim=64, metric="cos", dtype="f32")
    ref.add(np.arange(3000, dtype=np.uint64), x)
    port = index_from_arrays(jax_state(ref), device="cpu")
    cache = cache_on(port, guard)
    q = x[rng.choice(3000, 16, replace=False)] + 0.05
    got = replays_equal_eager(port, [q, q[::-1].copy()], 10)
    assert cache.captures == 1 and cache.replays == 1
    truth = port.search(q, 10, exact=True).keys
    qp = port._padded_queries(port._prepare_host(q, port._kind)).numpy()
    _, i = jexact.search_kernel(ref.metric, ref.dtype, jnp.asarray(qp), ref._table, ref._stats, ref._valid, ref.ndim,
                                10, 1024, approx=True)
    jkeys = np.asarray(i)[:16]
    recall = lambda keys: np.mean([len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(keys, truth)])
    assert recall(got[0].keys) >= recall(jkeys) - 0.005


@pytest.mark.parametrize("filtered", [False, True])
def test_flat_exact_b2(pallas_backend, guard, filtered):
    """B2, the bin top-k and the rescore chunks (i8 l2sq, deletions), with
    and without a filter's mask (a static input): replays equal eager, and
    the JAX index's exact search with distances bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (3000, 96)).astype(np.int8)
    keys = np.arange(3000, dtype=np.uint64) + 1000
    ref = usearch_tpu.Index(ndim=96, metric="l2sq", dtype="i8")
    ref.add(keys, x)
    ref.remove(keys[rng.choice(3000, 300, replace=False)])
    port = index_from_arrays(jax_state(ref), device="cpu")
    cache = cache_on(port, guard)
    odd = (lambda k: k % 2 == 1) if filtered else None
    batches = [x[rng.choice(3000, 5, replace=False)] for _ in range(2)]
    got = replays_equal_eager(port, batches, 10, exact=True, filter=odd)
    assert cache.captures == 1 and cache.keys()[0][0] == "flat" and cache.keys()[0][-1] == filtered
    for b, g in zip(batches, got):
        assert_same_flat(g, ref.search(b, 10, exact=True, filter=odd), exact_dists=True)


@pytest.fixture(scope="module")
def jax_ivf_i8():
    """A JAX index of i8 blobs, `optimize(12, reorder=True, spill=0.1)`, with
    deletions before and after the build and 20 fresh rows after it."""
    jexact.set_kernel_backend("pallas")
    try:
        rng = np.random.default_rng(11)
        x = data("i8", rng)
        n = len(x)
        ref = usearch_tpu.Index(ndim=x.shape[1], metric="ip", dtype="i8", expansion_search=24)
        keys = np.arange(n, dtype=np.uint64) + 100
        ref.add(keys, x)
        ref.remove(keys[rng.choice(n, 30, replace=False)])
        ref.optimize(n_partitions=12, reorder=True, spill=0.1)
        ref.remove(keys[rng.choice(n, 30, replace=False)])
        extra = data("i8", np.random.default_rng(12), n_per=4, centers=5)
        ref.add(np.arange(20, dtype=np.uint64) + 5000, extra)
        q = np.concatenate([x[rng.choice(n, 30, replace=False)], extra[:6]])
        return ref, q
    finally:
        jexact.set_kernel_backend("auto")


@pytest.mark.parametrize("mode,route,k", [("group", "group", 10), ("nofold", "nofold", 1)])
def test_ivf_probe(pallas_backend, guard, monkeypatch, jax_ivf_i8, mode, route, k):
    """The dense IVF of i8 blobs with shadows and fresh rows: coarse
    selection, pairs, B3 (``group``) or B5 (``nofold``), the shadow dedup,
    the fresh scan and its merge, as one body; replays equal eager, and the
    JAX index in the same flavour as test_torch_ivf.py holds it."""
    ref, q = jax_ivf_i8
    monkeypatch.setattr(ivf, "PROBE_MODE", mode)
    monkeypatch.setattr(jivf, "_PROBE_MODE", mode)
    if mode == "nofold":  # B5 needs a wide surface: nprobe x bins >= 8 x (2 k with shadows)
        monkeypatch.setattr(ref, "expansion_search", 200)
    port = carried(ref)
    cache = cache_on(port, guard)
    got = replays_equal_eager(port, [q[:32], q[4:36]], k)
    key = cache.keys()[0]
    assert cache.captures == 1 and cache.replays == 1 and key[:2] == ("ivf", route)
    assert key[5] == 128 and key[6] == port._ivf.shadow_np_pos.size > 0  # the fresh list's length, the shadows
    assert_same_ivf(got[0], ref.search(q[:32], k), "i8", "ip")


def pair_on_the_card(guard):
    """B6's wrapper as the card runs it (`probe.pair_probe`'s card branch):
    `pair_cells` under the guard, the two kernel steps through their plain
    versions (test_torch_pair_fold.py's decomposition) unguarded."""

    def pair_probe(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k, w_pad, bin_m):
        probe._check_pair(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k, w_pad, bin_m)
        qid, win_start, win_len, inv = probe.pair_cells(starts, offs, lens, table.shape[0], w_pad)
        with guard.armed(False):
            lists = probe.grouped_probe_plain(metric, q[qid].contiguous(), q_sq[qid].contiguous(), table, t_sq,
                                              penalty, win_start, win_len, k, min(bin_m, k), rank_form=True)
            out = probe.pair_fold_plain(metric, *lists, inv, q_sq, k)
        graphs.count_launch(probe.pair_probe)
        return out

    return pair_probe


@pytest.mark.parametrize("mode", ["pair", "bin"])
def test_ivf_opt_in_flavours(pallas_backend, guard, monkeypatch, jax_ivf_i8, mode):
    """The opt-in flavours over test_ivf_probe's index: B6 (``pair``, its
    card path's cells under the guard) and B7 (``bin``, its gate decided
    in the plan) as whole bodies; replays equal eager, and the JAX index in
    the same flavour as test_torch_probe_modes.py holds it."""
    ref, q = jax_ivf_i8
    monkeypatch.setattr(ivf, "PROBE_MODE", mode)
    monkeypatch.setattr(jivf, "_PROBE_MODE", mode)
    monkeypatch.setattr(ref, "expansion_search", 200)  # B7 needs a wide surface: 8 k bin winners
    monkeypatch.setattr(ivf, "pair_probe", pair_on_the_card(guard))
    port = carried(ref)
    cache = cache_on(port, guard)
    launches = probe.pair_probe.launches
    got = replays_equal_eager(port, [q[:32], q[4:36]], 10)
    assert cache.captures == 1 and cache.replays == 1 and cache.keys()[0][:2] == ("ivf", mode)
    if mode == "pair":  # the warm run, one replay, two eager searches
        assert probe.pair_probe.launches - launches == 4
    assert_same_ivf(got[0], ref.search(q[:32], 10), "i8", "ip")


def test_bin_gate_follows_removals(guard, monkeypatch, jax_ivf_i8):
    """Removals that leave less than `ivf.BIN_LIVE_FLOOR` of the rows live
    switch ``bin`` to its fallback at the next search, as eager does: a new
    key, whose replays equal eager and find no removed key. The share is
    read once a version of the mask."""
    ref, q = jax_ivf_i8
    monkeypatch.setattr(ivf, "PROBE_MODE", "bin")
    monkeypatch.setattr(ref, "expansion_search", 200)
    port = carried(ref)
    cache = cache_on(port, guard)
    reads = []
    share = ivf._live_fraction
    monkeypatch.setattr(ivf, "_live_fraction", lambda v: (reads.append(1), share(v))[1])
    replays_equal_eager(port, [q[:16], q[16:32]], 10)
    assert [key[1] for key in cache.keys()] == ["bin"] and len(reads) == 1
    built = np.setdiff1d(np.nonzero(port._valid.numpy())[0], port._ivf.fresh_np)  # removed in place
    gone = port._slot_keys[built[: int(0.6 * len(built))]]
    port.remove(gone)
    got = replays_equal_eager(port, [q[:16], q[16:32]], 10)
    # the fallback: B5's surface is too narrow for 2 k with the shadows, so B3
    assert [key[1] for key in cache.keys()] == ["bin", "group"] and cache.captures == 2 and len(reads) == 2
    assert not np.isin(np.concatenate([g.keys for g in got]), gone).any()


@pytest.mark.parametrize("metric,route", [("hamming", "group"), ("tanimoto", "binary")])
def test_binary_ivf(pallas_backend, guard, metric, route):
    """b1: hamming through B3's b1 flavour (B4), tanimoto through B5 and the
    popcount re-rank, each with deletions and fresh rows: replays equal
    eager, and the JAX index as test_torch_binary_ivf.py holds it."""
    rng = np.random.default_rng(11)
    x = bit_corpus(rng, 1200, 256, templates=10)
    n = len(x)
    ref = usearch_tpu.Index(ndim=256, metric=metric, dtype="b1", expansion_search=24)
    keys = np.arange(n, dtype=np.uint64) + 100
    ref.add(keys, x)
    ref.optimize(n_partitions=12, reorder=True)
    ref.remove(keys[rng.choice(n, 30, replace=False)])
    ref.add(np.arange(20, dtype=np.uint64) + 5000, x[:20] ^ np.uint8(1))
    port = carried_b1(ref)
    cache = cache_on(port, guard)
    q = x[rng.choice(n, 24, replace=False)]
    got = replays_equal_eager(port, [q[:16], q[8:]], 10)
    assert cache.captures == 1 and cache.keys()[0][:2] == ("ivf", route)
    assert_same_b1(got[0], ref.search(q[:16], 10), metric)


def test_mutations_recapture_or_replay(guard):
    """After a removal the key's graph replays (the mask is updated in place)
    and equals eager; fresh adds rebuild the fresh list (a new generation:
    a recapture); an add that grows the table bumps the index's generation.
    Every result equals eager."""
    rng = np.random.default_rng(5)
    x = data("i8", rng)
    port = usearch_torch.Index(ndim=x.shape[1], metric="ip", dtype="i8", device="cpu", expansion_search=24)
    keys = np.arange(len(x), dtype=np.uint64)
    port.add(keys, x)
    port.optimize(n_partitions=10, reorder=True, spill=0.05)
    cache = cache_on(port, guard)
    q = x[:8]
    replays_equal_eager(port, [q, q], 5)
    assert (cache.captures, cache.replays) == (1, 1)
    port.remove(keys[:3])  # in place: the shadows' primaries stay; all_live was False already
    gen = port._generation
    replays_equal_eager(port, [q], 5)
    assert (cache.captures, cache.replays, port._generation) == (1, 2, gen)
    port.add(np.arange(8, dtype=np.uint64) + 10000, x[3:11])  # the fresh list: rebuilt at the next search
    replays_equal_eager(port, [q], 5)
    assert cache.captures == 2 and len(cache) == 1
    assert cache.keys()[0][5] == 128
    before = port.capacity
    port.add(np.arange(3000, dtype=np.uint64) + 20000, np.repeat(x, 3, axis=0)[:3000])  # grows, drops the IVF
    assert port.capacity > before and port._generation > gen
    replays_equal_eager(port, [q], 5, exact=True)
    assert cache.captures == 3 and cache.keys()[0][0] == "flat"


@pytest.fixture(scope="module")
def shard_rows():
    rng = np.random.default_rng(12)
    rows = rng.standard_normal((8 * 1536, 32)).astype(np.float32)  # B2's tiles of 512
    return rows, rows[rng.choice(rows.shape[0], 16, replace=False)] + 0.01


def test_sharded_exact(guard, shard_rows):
    """8 CPU shards of 1,536 rows, each through B2's body: replays equal the
    eager search (the rescore chunks interleaved), and the JAX pool's keys
    with distances as test_torch_sharded.py holds B2's shards."""
    data_, queries = shard_rows
    pool = ShardedIndex.build(data_, metric="l2sq", mesh=make_mesh(8, device="cpu"))
    cache = cache_on(pool, guard, max_graphs=16)
    got = replays_equal_eager(pool, [queries, queries[::-1].copy()], 10, exact=True)
    assert cache.captures == 8 and cache.replays == 8
    assert sorted(key[-1] for key in cache.keys()) == list(range(8)) and cache.keys()[0][0] == "exact"
    sq = np.square(np.concatenate([data_, queries])).sum(axis=1)
    want = JaxSharded.build(data_, metric="l2sq", mesh=jax_mesh()).search(queries, 10)
    assert_same_sharded(got[0], want, 2e-6 * sq.max())


def test_sharded_probed(guard):
    """8 CPU shards after `optimize(4)`, each shard's B3 probe as a body:
    replays equal eager, and a full probe equals the JAX pool's exact
    search within test_torch_sharded.py's IVF tolerance."""
    data_, rng = blobs(8, 8, 150, 32)
    keys = np.arange(data_.shape[0], dtype=np.uint64) * 7 + 3
    queries = data_[rng.choice(data_.shape[0], 16, replace=False)]
    pool = ShardedIndex.build(data_, keys, metric="cos", mesh=make_mesh(8, device="cpu"))
    pool.optimize(n_partitions=4)
    cache = cache_on(pool, guard, max_graphs=16)
    got = replays_equal_eager(pool, [queries, queries[::-1].copy()], 9, expansion_search=100000)
    assert cache.captures == 8 and cache.keys()[0][0] == "probe"
    want = JaxSharded.build(data_, keys, metric="cos", mesh=jax_mesh()).search(queries, 9)
    assert_same_sharded(got[0], want, IVF_ATOL)
    gen = pool._generation
    pool.reserve(2 * len(keys))  # replaces the shards' tensors: a new generation
    assert pool._generation == gen + 1
    replays_equal_eager(pool, [queries], 9, expansion_search=100000)
    assert cache.captures == 16


# ----------------------------------------------------------------------
# The cache
# ----------------------------------------------------------------------


def counting_body(x):
    """One B1 launch and two B3 launches, counted as the wrappers count
    them."""
    graphs.count_launch(scan.binned_scan)
    for _ in range(2):
        graphs.count_launch(probe.grouped_probe)
    return (x * 2,)


def test_cache_keys_lru_and_generation():
    """A key captures once and replays after; past ``max_graphs`` the least
    recently used key goes; a new generation empties the cache and resets
    the backend's pool."""
    cache = GraphCache("cpu", backend=StandIn(), max_graphs=2)
    x = torch.arange(4.0)
    for key in ("a", "b", "a", "c"):  # "b" is the least recently used when "c" comes
        (out,) = cache.run((key,), 0, lambda t: (t + 1,), (x,))
        assert torch.equal(out, x + 1)
    assert cache.keys() == [("a",), ("c",)] and cache.captures == 3 and cache.replays == 1
    (out,) = cache.run(("a",), 0, lambda t: (t + 1,), (x * 3,))  # a replay on new inputs
    assert torch.equal(out, x * 3 + 1) and cache.replays == 2
    cache.run(("a",), 1, lambda t: (t + 1,), (x,))
    assert cache.keys() == [("a",)] and cache.captures == 4 and cache._backend.resets == 1


def test_replays_count_their_launches():
    """The warm run's launches count, the capture's are taken back, and each
    replay adds the launches its capture recorded."""
    cache = GraphCache("cpu", backend=StandIn())
    b1, b3 = scan.binned_scan.launches, probe.grouped_probe.launches
    cache.run(("k",), 0, counting_body, (torch.ones(2),))
    assert (scan.binned_scan.launches - b1, probe.grouped_probe.launches - b3) == (1, 2)
    for i in range(3):
        (out,) = cache.run(("k",), 0, counting_body, (torch.full((2,), float(i)),))
        assert torch.equal(out, torch.full((2,), 2.0 * i))
    assert (scan.binned_scan.launches - b1, probe.grouped_probe.launches - b3) == (4, 8)
    entry = cache._graphs[("k",)]
    assert entry.launches == {scan.binned_scan: 1, probe.grouped_probe: 2}


def test_a_capture_records_only_its_own_thread_launches():
    """Launches another thread counts while a capture runs go on the
    counters, not into the graph's recorded launches."""
    cache = GraphCache("cpu", backend=StandIn())

    def body(x):
        other = threading.Thread(target=lambda: [graphs.count_launch(scan.binned_scan) for _ in range(5)])
        other.start()
        other.join()
        return counting_body(x)

    b1 = scan.binned_scan.launches
    cache.run(("k",), 0, body, (torch.ones(2),))  # the warm run: 6 B1 launches, the capture's other thread: 5
    assert scan.binned_scan.launches - b1 == 11
    assert cache._graphs[("k",)].launches == {scan.binned_scan: 1, probe.grouped_probe: 2}


class SharedPool(StandIn):
    """A stand-in whose graphs all write their outputs to one buffer, as
    graphs of one pool may reuse each other's blocks, half at a time with a
    pause between (a replay lets go of the GIL)."""

    def __init__(self):
        super().__init__()
        self.out = torch.zeros(64)

    def capture(self, body, args):
        return [body, args], (self.out,)

    def replay(self, graph):
        body, args = graph
        (fresh,) = body(*args)
        self.out[:32] = fresh[:32]
        time.sleep(1e-4)
        self.out[32:] = fresh[32:]


def test_replays_of_one_pool_from_two_threads():
    """Two threads replay two keys of one cache whose graphs share their
    output blocks: each result is its own body's, not the other's."""
    cache = GraphCache("cpu", backend=SharedPool())
    bodies = {"a": lambda t: (t + 1,), "b": lambda t: (t * -1,)}
    wrong = []

    def hammer(key, base):
        for i in range(200):
            x = torch.full((64,), float(base + i))
            (out,) = cache.run((key,), 0, bodies[key], (x,))
            if not torch.equal(out, bodies[key](x)[0]):
                wrong.append(key)

    threads = [threading.Thread(target=hammer, args=(key, base)) for key, base in (("a", 0), ("b", 1000))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not wrong and cache.replays == 398


def test_pools_held_to_the_device_budget(monkeypatch):
    """Past the budget the caches used least recently are emptied, never the
    one that just captured."""
    monkeypatch.setattr(graphs, "pool_budget", lambda device: 250)
    caches = [GraphCache("cpu", backend=StandIn(graph_bytes=100)) for _ in range(3)]
    one = lambda t: (t + 1,)  # noqa: E731
    for c in caches:
        c.run(("a",), 0, one, (torch.ones(2),))
    assert [len(c) for c in caches] == [0, 1, 1]  # the third capture: 300 bytes, the first cache the oldest
    caches[1].run(("a",), 0, one, (torch.ones(2),))  # a replay: the second cache is used again
    caches[0].run(("a",), 0, one, (torch.ones(2),))
    assert [len(c) for c in caches] == [1, 1, 0]
    caches[0].run(("b",), 0, one, (torch.ones(2),))  # 200 bytes of its own: the second cache goes
    assert [len(c) for c in caches] == [2, 0, 0]


def test_a_profiler_session_gets_graphs_captured_since_the_last(monkeypatch):
    """A search that sees the profiler's state change drops the graphs: a
    session replays only graphs captured within it."""
    from torch.autograd import profiler

    cache = GraphCache("cpu", backend=StandIn())
    one = lambda t: (t + 1,)  # noqa: E731
    for on, captures in ((True, 1), (True, 1), (False, 2), (False, 2), (True, 3), (True, 3), (False, 4)):
        monkeypatch.setattr(profiler, "_is_profiler_enabled", on)
        cache.run(("a",), 0, one, (torch.ones(2),))
        assert cache.captures == captures


def test_a_failed_capture_raises_and_caches_nothing(guard):
    """A body that reads to the host fails its capture: the error reaches the
    caller, nothing is cached, and no eager result is returned."""
    cache = GraphCache("cpu", backend=StandIn(guard))

    def reads(t):
        return (t * int(t.sum()),)

    with pytest.raises(AssertionError, match="host read"):
        cache.run(("r",), 0, reads, (torch.ones(3),))
    assert len(cache) == 0 and cache.captures == 0


def test_index_keys_and_generation(guard):
    """The keys an index's searches take: the path, k, the padded query
    count, the filter flag; mutations that replace tensors bump the
    generation, a removal does not; the eager paths take no key."""
    rng = np.random.default_rng(6)
    x = data("i8", rng)
    port = usearch_torch.Index(ndim=x.shape[1], metric="ip", dtype="i8", device="cpu")
    port.reserve(3072)  # B2's tiles of 1,024 (one tile of 2,048 takes the plain scan, as in the JAX package)
    port.add(np.arange(len(x), dtype=np.uint64), x)
    plan = lambda n, k, approx=False, ivf_=False: port._search_plan(n, k, port._valid, approx, ivf_)[0]  # noqa: E731
    assert plan(8, 4) == ("flat", False, plan(8, 4)[2])
    assert plan(8, 40) is None  # past B2's k: the plain scan
    g = port._generation
    port.remove([0, 1])
    assert port._generation == g
    port.reserve(port.capacity * 4)
    assert port._generation == g + 1
    port.optimize(n_partitions=8, reorder=True)
    assert port._generation == g + 2
    assert plan(8, 4, ivf_=True)[:2] == ("ivf", "group")
    for mode in ("pair", "bin"):  # captured too: bin's gate is decided in the plan
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ivf, "PROBE_MODE", mode)
            assert plan(8, 4, ivf_=True)[:2] == ("ivf", mode)
    port.compact()
    assert port._generation == g + 3
    port.clear()
    assert port._generation == g + 4
    assert not port.jit  # on the CPU the body runs eagerly
    assert pad_queries(5) == 8 and set(graphs.EAGER) >= {"streamed views", "exact_search", "add"}
    assert not {"pair", "bin"} & set(graphs.EAGER)
