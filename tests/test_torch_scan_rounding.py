"""What lets the tensor-core scan kernels (csrc/scan.cu) sum bf16 products in
another order than the plain versions: the searches built on B1 and B2 hold
their results when the kernels' outputs move as far as chip_smoke.py lets
them move.

- B2 (exact search): every bin minimum moved adversarially by the float
  tolerance chip_smoke.py holds the kernel to (FLOAT_RTOL, FLOAT_ATOL), up
  on the bins that hold a query's true neighbours and down elsewhere; the
  `EXACT_BIN_SLACK` extra bins absorb it, so `search_exact` still returns
  the brute-force answer apart from ties.
- B1 compact (approximate search over f32 storage): every bf16 minimum
  moved by one bf16 ulp the same way, and the arg-min swapped to the second
  best row on bins whose two best rows lie within FLOAT_ATOL (chip_smoke.py
  holds the arg-mins equal only on bins with a wider gap); the recall@1
  against the exact answer stays at or above the JAX reference's on the
  same corpus.
- The sources: one bit-exact epilogue, in csrc/scan_common.cuh, included by
  scan.cu and fused.cu."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402
from usearch_torch.ops.distances import MASKED, dot, row_stats, scan_epilogue  # noqa: E402

METRICS = ["ip", "cos", "l2sq"]
#: chip_smoke.py's tolerance for float bin minima against the plain version
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-4
CSRC = Path(__file__).resolve().parents[1] / "usearch_torch" / "csrc"


def corpus(dtype, n=8192, nq=48, w=128, seed=0):
    """Rows with a cluster structure (64 centres), ~10% deleted, and member
    queries with a little noise, so neighbours sit in few bins and near
    ties across bins are common."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((64, w)).astype(np.float32)
    t = centres[rng.integers(0, 64, n)] + 0.3 * rng.standard_normal((n, w)).astype(np.float32)
    q = t[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal((nq, w)).astype(np.float32)
    valid = torch.from_numpy(rng.random(n) >= 0.1)
    table = torch.from_numpy(t).to(dtype)
    return table, torch.from_numpy(q).to(dtype), row_stats(table, ScalarKind.F32), valid


def brute_force(metric, q, table, stats, valid, k):
    """Exact f32 distances of every row, by the rescore's own arithmetic."""
    q_sq = scan.scan_aux(metric, q, stats, valid)[0]
    ids = torch.arange(table.shape[0]).expand(q.shape[0], -1)
    d, i = scan.rescore_exact(metric, q, q_sq, table, stats, valid, ids)
    return d[:, :k], i[:, :k]


def holds_neighbour(ids, n_bins):
    """``[Q, n_bins]`` mask of the bins holding one of each query's ids."""
    mask = torch.zeros((ids.shape[0], n_bins), dtype=torch.bool)
    mask.scatter_(1, ids // scan.LANES, True)
    return mask


def same_apart_from_ties(got, want):
    (gd, gi), (wd, wi) = got, want
    assert torch.equal(gd, wd)
    for row in range(gi.shape[0]):
        vals = wd[row]
        unique = (vals[:, None] == vals[None, :]).sum(1) == 1
        assert torch.equal(gi[row][unique], wi[row][unique]), row


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_absorbs_float_tolerance(monkeypatch, metric, dtype):
    metric = MetricKind(metric)
    table, q, stats, valid = corpus(torch.bfloat16 if dtype == "bf16" else torch.float32)
    k = 10
    want = brute_force(metric, q, table, stats, valid, k)
    plain = scan.binned_minima_plain
    near = holds_neighbour(want[1], table.shape[0] // scan.LANES)

    def moved(metric, q, table, q_sq, t_sq, penalty):
        v = plain(metric, q, table, q_sq, t_sq, penalty)
        step = FLOAT_ATOL + FLOAT_RTOL * v.abs()
        return torch.where(near, v + step, v - step)

    monkeypatch.setattr(scan, "binned_minima", moved)
    got = scan.search_exact(metric, q, table, stats, valid, k)
    same_apart_from_ties(got, want)


def bf16_step(x, up):
    """``x`` (bf16) moved one bf16 ulp up where ``up``, down elsewhere."""
    bits = x.view(torch.int16).int()
    ordered = torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    ordered = ordered + torch.where(up, 1, -1)
    bits = torch.where(ordered >= 0, ordered, (-ordered) | 0x8000)
    return bits.to(torch.int16).view(torch.bfloat16)


def recall_at(ids, truth):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, truth)])


@pytest.mark.parametrize("metric", METRICS)
def test_compact_recall_under_bf16_rounding(monkeypatch, metric):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from usearch_tpu.enums import MetricKind as JMetric
    from usearch_tpu.ops import pallas_scan as jscan

    m = MetricKind(metric)
    table, q, stats, valid = corpus(torch.float32, seed=3)
    n, k = table.shape[0], 10
    truth = brute_force(m, q, table, stats, valid, k)[1]
    near = holds_neighbour(truth, n // scan.LANES)
    plain = scan.binned_scan_plain

    def moved(metric, q, table, q_sq, t_sq, penalty, compact=False):
        v, a = plain(metric, q, table, q_sq, t_sq, penalty, compact)
        assert compact
        # the two best rows of every bin, from bf16-rounded operands
        d = scan_epilogue(metric, dot(q.to(torch.bfloat16), table.to(torch.bfloat16)), q_sq, t_sq, penalty, True)
        two = torch.topk(d.view(d.shape[0], -1, scan.LANES), 2, dim=-1, largest=False)
        tie = (two.values[..., 1] - two.values[..., 0] <= FLOAT_ATOL) & (two.values[..., 0] < MASKED / 2)
        a = torch.where(tie, two.indices[..., 1].to(torch.int8), a)
        return bf16_step(v, near), a

    monkeypatch.setattr(scan, "binned_scan", moved)
    got = scan.search_binned(m, q, table, stats, valid.clone(), k, compact=True)
    jt, jq = jnp.asarray(table.numpy()), jnp.asarray(q.numpy())
    want = jscan.pallas_search_binned(JMetric(metric), jq, jt, stats.numpy(), jnp.asarray(valid.numpy()), k,
                                      q_tile=q.shape[0], t_tile=2048, interpret=True, transposed=True,
                                      compute_bf16=True, compact=True, oversample=scan.OVERSAMPLE)
    truth = truth.numpy()
    got_ids, want_ids = got[1].numpy(), np.asarray(want[1])
    assert recall_at(got_ids[:, :1], truth[:, :1]) >= recall_at(want_ids[:, :1], truth[:, :1])


def test_epilogue_defined_once():
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    defined = [p.name for p in sources if re.search(r"float\s+epilogue\s*\(", p.read_text())]
    assert defined == ["scan_common.cuh"]


@pytest.mark.parametrize("source", ["scan.cu", "fused.cu"])
def test_scan_sources_share_the_header(source):
    text = (CSRC / source).read_text()
    assert '#include "scan_common.cuh"' in text
    for name in (r"enum\s+Metric", r"enum\s+DType", r"enum\s+Mode", r"struct\s+Acc", r"float\s+to_float\s*\(",
                 r"float\s+lo_bf16\s*\(", r"float\s+hi_bf16\s*\("):
        assert not re.search(name, text), (source, name)


@pytest.mark.parametrize("part", ["no_stores", "no_epilogue", "no_product", "no_query_loads", "product_only",
                                  "query_loads_only"])
def test_scan_breakdown_variants_apply(part):
    """Each variant of the breakdown script replaces lines the kernel still
    has, so a change of csrc/scan.cu cannot leave it timing the full kernel."""
    from usearch_torch.microbench import scan_breakdown

    full = (CSRC / "scan.cu").read_text()
    text = scan_breakdown._variant_source(scan_breakdown.PARTS[part])
    assert text != full and "wgmma_scan" in text


@pytest.mark.parametrize("part", ["simt_product_only", "simt_copies_only", "simt_no_epilogue"])
def test_scan_breakdown_simt_variants_apply(part):
    """Each variant of the SIMT f32 kernel (B2/B1 f32) replaces lines that
    `simt_scan` still has."""
    from usearch_torch.microbench import scan_breakdown

    full = (CSRC / "scan.cu").read_text()
    body = full[full.index("simt_scan(const float*"):full.index("int launch_simt(")]
    for old, _ in scan_breakdown.SIMT_PARTS[part]:
        assert old in body, old
    assert scan_breakdown._variant_source(scan_breakdown.SIMT_PARTS[part]) != full


def test_scan_breakdown_needs_a_card(monkeypatch):
    from usearch_torch.microbench import scan_breakdown

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert scan_breakdown.main() == 1
