"""The IVF probe flavours (`ivf.PROBE_MODE`) on the CPU: kernel B5's plain
version over numeric tables against the TPU kernel
`pallas_ivf_probe_grouped_nofold` in Pallas interpret mode, the dispatch of
each flavour, whole-`Index` searches in ``pair``, ``bin`` and ``nofold``
mode against the JAX Index in the same mode (its Pallas kernels in
interpret mode through ``set_kernel_backend("pallas")``, the build carried
across by `convert.install_ivf`), and each flavour's recall and deletes on
the port's own build.

Tolerances are test_torch_probe.py's: i8 ip and l2sq bit for bit, i8 cos
within 4 f32 ulps of 1 with ids equal, bf16 and f32 within rtol 1e-5 with
ids equal apart from near ties."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_ivf import assert_same, carried, make_index, unit_blobs  # noqa: E402
from test_torch_probe import Layout, assert_probe_equal  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402
from usearch_tpu import ivf as jivf  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops.pallas_probe import pallas_ivf_probe_grouped_nofold  # noqa: E402

from usearch_torch import ivf  # noqa: E402
from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402

FLAVOURS = {
    "pair": "_ivf_probe_search_dense_pair",
    "bin": "_ivf_probe_search_dense_binned",
    "nofold": "_ivf_probe_search_dense_nofold",
    "group": "_ivf_probe_search_dense_grouped",
    "xla": "_ivf_probe_search_dense_grouped",
}


@pytest.fixture
def pallas_backend():
    jexact.set_kernel_backend("pallas")
    try:
        yield
    finally:
        jexact.set_kernel_backend("auto")


@pytest.fixture
def calls(monkeypatch):
    """Which probe function each search reached, by name."""
    seen = []
    for name in set(FLAVOURS.values()) | {"_ivf_probe_search_dense", "_ivf_probe_search_dense_binary"}:
        fn = getattr(ivf, name)
        monkeypatch.setattr(ivf, name, lambda *a, _fn=fn, _name=name, **kw: (seen.append(_name), _fn(*a, **kw))[1])
    return seen


@pytest.mark.parametrize("dtype,metric", [(d, m) for d in ("i8", "bf16", "f32") for m in ("ip", "cos", "l2sq")])
def test_nofold_numeric_plain_matches_pallas(dtype, metric):
    """B5 over numeric rows, 4 per bin: each pair's [out_pad] surface of
    final distances, round-major, MASKED/-1 past the candidates."""
    lay = Layout(dtype, seed=70)
    bin_m = 4
    t_aux = lay.penalty[None, :] if metric == "ip" else np.stack(
        [lay.t_sq, lay.t_sum, lay.penalty, np.zeros_like(lay.penalty)])
    qid = np.asarray(lay.qid_s)
    q_aux = np.zeros((lay.p_total, 8), np.float32)
    q_aux[:, 0] = lay.q_sq[qid]
    q_aux[:, 2] = np.asarray(lay.widx).reshape(-1)
    want = pallas_ivf_probe_grouped_nofold(JMetric(metric), lay.q_g, jnp.asarray(q_aux), lay.jt, jnp.asarray(t_aux),
                                           lay.meta, lay.w_pad, 128, bin_m, True)
    st_c, off, ln = (torch.from_numpy(x.astype(np.int32)) for x in lay.pair_windows())
    args = (MetricKind(metric), lay.tq[torch.from_numpy(qid.copy())].contiguous(), torch.from_numpy(lay.q_sq[qid]),
            lay.tt, None if metric == "ip" else torch.from_numpy(lay.t_sq), torch.from_numpy(lay.penalty), st_c,
            st_c + off, ln, lay.w_pad)
    got = probe.grouped_probe_nofold(*args, bin_m)
    assert_probe_equal(tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want), dtype, metric)
    n_cand = bin_m * (lay.w_pad // 128)
    assert (got[1][:, n_cand:] == -1).all() and (got[1][: lay.p0] >= 0).any()
    with pytest.raises(ValueError):  # numeric rows keep at most 8 per bin
        probe.grouped_probe_nofold(*args, 9)


def blob_index(dtype="i8", metric="ip", n_per=150, centers=20, ndim=32, parts=48, es=170, spill=0.0, seed=80):
    rng = np.random.default_rng(seed)
    x = unit_blobs(rng, n_per, centers, ndim, 0.3)
    index = make_index(ndim=ndim, metric=metric, dtype=dtype, expansion_search=es)
    keys = index.add(None, x)
    index.optimize(n_partitions=parts, reorder=True, spill=spill)
    return index, x, keys


@pytest.mark.parametrize("mode", ["group", "xla", "nofold", "bin", "pair"])
def test_each_mode_reaches_its_probe(monkeypatch, calls, mode):
    """At k 10 on a wide probe surface, each flavour takes its own path."""
    index, x, _ = blob_index()
    monkeypatch.setattr(ivf, "PROBE_MODE", mode)
    index.search(x[:16], 10)
    assert calls == [FLAVOURS[mode]]


def test_mode_fallbacks(monkeypatch, calls):
    """``bin`` under a 25% filter (tests/test_probe.py:155's) takes B5;
    ``nofold`` at k > 64 and on a narrow surface takes B3; ``pair`` with a
    batch that is not a multiple of 8 takes the plain probe; tanimoto goes
    through B5 and the re-rank in every mode; b1 hamming in ``bin`` mode
    takes B5 (B7 is i8 only)."""
    index, x, keys = blob_index()
    allow = keys[::4]
    monkeypatch.setattr(ivf, "PROBE_MODE", "bin")
    m = index.search(x[:8], 10, filter=allow)
    assert calls[-1] == "_ivf_probe_search_dense_nofold" and np.isin(m.keys, allow).all()
    monkeypatch.setattr(ivf, "PROBE_MODE", "nofold")
    index.search(x[:8], 65)
    assert calls[-1] == "_ivf_probe_search_dense_grouped"
    index.expansion_search = 1  # one probe: 1 x 2 bins < 8 k
    index.search(x[:8], 10)
    assert calls[-1] == "_ivf_probe_search_dense_grouped"
    monkeypatch.setattr(ivf, "PROBE_MODE", "pair")
    iv, q = index._ivf, index._cast_device(torch.from_numpy(x[:12]), ScalarKind.F32)
    iv._search_dense(index, q, index._valid, 10, 4, False, False)
    assert calls[-1] == "_ivf_probe_search_dense"
    iv._search_dense(index, q[:8], index._valid, 10, 4, False, False)
    assert calls[-1] == "_ivf_probe_search_dense_pair"
    bits = (np.random.default_rng(81).random((600, 256)) > 0.5).astype(np.float32)
    for metric, mode, want in (("tanimoto", "pair", "_ivf_probe_search_dense_binary"),
                               ("tanimoto", "bin", "_ivf_probe_search_dense_binary"),
                               ("hamming", "bin", "_ivf_probe_search_dense_nofold"),
                               ("hamming", "pair", "_ivf_probe_search_dense_pair")):
        b1 = make_index(ndim=256, metric=metric, dtype="b1", expansion_search=200)
        b1.add(None, bits)
        b1.optimize(n_partitions=12, reorder=True)
        monkeypatch.setattr(ivf, "PROBE_MODE", mode)
        assert b1.search(bits[:8], 2).keys[:, 0].tolist() == list(range(8))  # 12 probes x 2 bins >= 8 k
        assert calls[-1] == want


def test_mode_knobs(monkeypatch, calls):
    """An unknown flavour and the TPU diagnostic selection raise; the
    grouped probe keeps 4 per bin on a wide surface and k on a narrow one
    (`probe_bin_m`, no override)."""
    index, x, _ = blob_index()
    monkeypatch.setattr(ivf, "PROBE_MODE", "fused")
    with pytest.raises(ValueError, match="PROBE_MODE"):
        index.search(x[:8], 10)
    q_g, table = torch.zeros((128, 128), dtype=torch.int8), torch.zeros((256, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="dotonly"):
        probe.binned_probe(q_g, table, torch.zeros(128, dtype=torch.int32), 256, 32, 4, "dotonly")
    monkeypatch.setattr(ivf, "PROBE_MODE", "group")
    bins = []
    monkeypatch.setattr(ivf, "grouped_probe", lambda *a: (bins.append(a[-1]), probe.grouped_probe(*a))[1])
    index.search(x[:8], 10)
    index.expansion_search = 1  # one probe: 1 x 2 bins < 8 k
    index.search(x[:8], 10)
    assert bins == [4, 10]


def test_live_share_follows_in_place_removals(monkeypatch, calls):
    """The live share is cached by the mask and its version: removing rows
    in place updates it, and ``bin`` leaves for B5 below half live."""
    index, x, keys = blob_index()
    monkeypatch.setattr(ivf, "PROBE_MODE", "bin")
    index.search(x[:8], 10)
    assert calls[-1] == "_ivf_probe_search_dense_binned"
    index.remove(keys[: int(0.6 * len(keys))])
    m = index.search(x[:8], 10)
    assert calls[-1] == "_ivf_probe_search_dense_nofold"
    assert not np.isin(m.keys, keys[: int(0.6 * len(keys))]).any()


PARITY = [(mode, dt, m) for mode in ("pair", "bin", "nofold") for dt, m in (("i8", "ip"), ("i8", "cos"), ("i8", "l2sq"))]
PARITY += [("pair", "f32", "l2sq"), ("nofold", "bf16", "cos")]


@pytest.mark.parametrize("mode,dtype,metric", PARITY)
def test_carried_index_matches_reference_per_mode(pallas_backend, monkeypatch, calls, mode, dtype, metric):
    """Built by the JAX Index (deletions before the build, deletions and
    fresh adds after it, spill shadows), carried across, searched by both in
    the same flavour."""
    rng = np.random.default_rng(90)
    x = unit_blobs(rng, 100, 12, 32, 0.3)
    if dtype == "i8":  # stored verbatim by both: no quantizer in the way
        x = np.clip(np.round(x * 100), -127, 127).astype(np.int8)
    n = len(x)
    ref = usearch_tpu.Index(ndim=32, metric=metric, dtype=dtype, expansion_search=48)
    keys = np.arange(n, dtype=np.uint64) + 100
    ref.add(keys, x)
    ref.remove(keys[rng.choice(n, 30, replace=False)])
    ref.optimize(n_partitions=40, reorder=True, spill=0.1)
    ref.remove(keys[rng.choice(n, 30, replace=False)])
    extra = unit_blobs(np.random.default_rng(91), 2, 4, 32, 0.3)
    if dtype == "i8":
        extra = np.clip(np.round(extra * 100), -127, 127).astype(np.int8)
    ref.add(np.arange(8, dtype=np.uint64) + 5000, extra)
    port = carried(ref)
    q = np.concatenate([x[rng.choice(n, 24, replace=False)], extra])
    monkeypatch.setattr(jivf, "_PROBE_MODE", mode)
    monkeypatch.setattr(ivf, "PROBE_MODE", mode)
    want_path = FLAVOURS["nofold" if mode == "bin" and dtype != "i8" else mode]
    for k in (1, 4):
        assert_same(port.search(q, k), ref.search(q, k), dtype, metric)
    assert calls and set(calls) == {want_path}


@pytest.mark.parametrize("mode", ["pair", "bin", "nofold"])
def test_mode_recall_and_removals(monkeypatch, calls, mode):
    """tests/test_probe.py's blob corpus (24,000 rows, 64 partitions) at
    expansion 512 (29 probes, 4 per bin): each flavour's recall@10 against
    the exact answer stays within 0.02 of the grouped probe's and above
    0.9, and removed keys never come back."""
    rng = np.random.default_rng(7)
    cents = rng.standard_normal((40, 64)) * 3
    x = (cents[rng.integers(0, 40, 24000)] + rng.standard_normal((24000, 64))).astype(np.float32)
    q = (cents[rng.integers(0, 40, 64)] + rng.standard_normal((64, 64))).astype(np.float32)
    index = make_index(ndim=64, metric="ip", dtype="i8", expansion_search=512)
    keys = index.add(None, x)
    index.optimize(n_partitions=64, reorder=True)
    exact = index.search(q, 10, exact=True).keys
    got_group = index.search(q, 10).keys
    monkeypatch.setattr(ivf, "PROBE_MODE", mode)
    got = index.search(q, 10).keys
    assert calls == [FLAVOURS["group"], FLAVOURS[mode]]

    def recall(a):
        return np.mean([len(set(r.tolist()) & set(e.tolist())) / 10 for r, e in zip(a, exact)])

    assert recall(got) >= max(recall(got_group) - 0.02, 0.9), (recall(got), recall(got_group))
    gone = got[:, 0]
    index.remove(gone)
    assert not np.isin(index.search(q, 10).keys, gone).any()
    assert len(index) == len(keys) - len(set(gone.tolist()))
