"""The tensor-core sources of the flat scans: B1/B2 (csrc/scan.cu) and
B8/B9/B10 (csrc/fused.cu) share one copy of the `wgmma` building blocks and
the register epilogue (csrc/wgmma_common.cuh), and each variant of the
fused breakdown script still replaces lines the kernel has, B10's store
flavour included."""

import inspect
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from usearch_torch.microbench import fused_breakdown, scan_breakdown  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "usearch_torch" / "csrc"
#: definitions that live in csrc/wgmma_common.cuh alone
SHARED = (r"struct\s+Aux\b", r"void\s+mma_k\s*\(", r"void\s+fence_acc\s*\(", r"uint64_t\s+sw128_desc\s*\(",
          r"void\s+tma_load\s*\(", r"void\s+mbar_wait\s*\(", r"float\s+dot_value\s*\(", r"void\s+keep_min\s*\(",
          r"void\s+bin_min\s*\(", r"void\s+keyed_bin_min\s*\(", r"void\s+tile_minima\s*\(",
          r"void\s+query_values\s*\(", r"void\s+set_row\s*\(", r"bool\s+tile_map\s*\(")


@pytest.mark.parametrize("pattern", SHARED)
def test_wgmma_blocks_defined_once(pattern):
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    defined = [p.name for p in sources if re.search(pattern, p.read_text())]
    assert defined == ["wgmma_common.cuh"], (pattern, defined)


@pytest.mark.parametrize("source", ["scan.cu", "fused.cu"])
def test_tensor_core_sources_share_the_header(source):
    assert '#include "wgmma_common.cuh"' in (CSRC / source).read_text()


def test_fused_kernels_take_the_shared_epilogue():
    text = (CSRC / "fused.cu").read_text()
    body = text[text.index("fused_wgmma(const __grid_constant__"):]
    assert "tile_minima<kMetric, false, kSmall>" in body and "set_row<false>" in body


@pytest.mark.parametrize("part", [p for p in fused_breakdown.PARTS if p != "full"])
def test_fused_breakdown_variants_apply(part):
    """Each variant replaces lines csrc/fused.cu still has, so a change of
    the kernel cannot leave it timing the full kernel."""
    full = (CSRC / "fused.cu").read_text()
    text = scan_breakdown._variant_source(fused_breakdown.PARTS[part], "fused.cu")
    assert text != full and "fused_wgmma" in text


def _fused_wgmma_body(text: str) -> str:
    start = text.index("{", text.index("fused_wgmma(const __grid_constant__"))
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start : i + 1]
        i += 1


@pytest.mark.parametrize("part", ["no_stores", "no_epilogue", "product_only", "stream_only"])
def test_fused_breakdown_b10_variants_reach_the_store_flavour(part):
    """The variants that time B10 replace lines of `fused_wgmma` (or of a
    helper it calls) that its store flavour runs: inside the kStore branch,
    or outside every flavour's branch; and the script times B10."""
    text = (CSRC / "fused.cu").read_text()
    body = _fused_wgmma_body(text)
    store = body.index("if constexpr (kFlavour == kStore) {")
    merge = body.index("} else if constexpr (kFlavour == kMerge) {", store)
    insert_end = body.index("if (owner) insert(", merge)
    for old, _ in fused_breakdown.PARTS[part]:
        at = body.find(old)
        assert at >= 0 or old in text.replace(body, ""), old  # in the kernel, or in a helper it calls
        assert store < at < merge or not merge <= at <= insert_end, old
    assert '"B10 i8 ip' in inspect.getsource(fused_breakdown.cases)
    if part == "no_stores":
        assert all(store < body.index(old) < merge for old, _ in fused_breakdown.PARTS[part])


def test_fused_breakdown_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fused_breakdown.main() == 1


def _statements(text: str, name: str):
    """The statements of the body of the device function ``name``."""
    start = text.index("{", re.search(r"void\s+" + name + r"\s*\(", text).end())
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            break
        i += 1
    return [" ".join(line.split()) for line in text[start + 1 : i].split(";") if line.strip()]


@pytest.mark.parametrize("name,renames", [
    ("set_row", {"kShifted": "kMode == kCompact"}),
    ("query_values", {}),
])
def test_b1_keeps_the_shared_row_and_query_values(name, renames):
    """B1 computes its rows' and queries' values inline (a call changes its
    SASS); every assignment of the shared function B8/B9 call is in B1's
    source too, so both feed the one epilogue the same values."""
    header = (CSRC / "wgmma_common.cuh").read_text()
    b1 = " ".join((CSRC / "scan.cu").read_text().split())
    assigned = [st for st in _statements(header, name) if re.match(r"^[\w.\[\]]+ = ", st) and "odd" not in st]
    assert len(assigned) >= 3
    for st in assigned:
        for old, new in renames.items():
            st = st.replace(old, new)
        assert st + ";" in b1, st
