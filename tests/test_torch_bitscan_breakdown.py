"""The b1 bit scan's breakdown script (usearch_torch/microbench/
bitscan_breakdown.py): each variant and the counting build still replace
lines of csrc/bitscan.cu's scan kernel (or of a helper it alone calls), so
a change of the kernel cannot leave a variant timing the full kernel, and
its report parser reads nvcc's registers and spills."""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from usearch_torch.microbench import bitscan_breakdown, scan_breakdown  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "usearch_torch" / "csrc"


def _body(text: str, signature: str) -> str:
    """The body of the function whose definition starts with ``signature``."""
    start = text.index("{", text.index(signature))
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start : i + 1]
        i += 1


def _scan_code(text: str) -> str:
    """The scan kernel's body, those of the device helpers it calls and
    that of the entry point that launches it."""
    return "".join(_body(text, sig) for sig in ("bit_scan_wgmma(const __grid_constant__", "void bit_release(",
                                                "void issue_tile(", "void filter_tile(", "void select_query(",
                                                "void insert_pair(", "int usearch_bit_scan("))


@pytest.mark.parametrize("part", [p for p in bitscan_breakdown.PARTS if p != "full"] + ["counts"])
def test_variants_apply_to_the_scan_kernel(part):
    full = (CSRC / "bitscan.cu").read_text()
    edits = bitscan_breakdown.COUNTS if part == "counts" else bitscan_breakdown.PARTS[part]
    text = scan_breakdown._variant_source(edits, "bitscan.cu")
    assert text != full and "bit_scan_wgmma" in text
    code = _scan_code(full)
    for old, _ in edits:
        assert old in code or part == "counts", old
    if part == "counts":
        assert "usearch_bit_scan_counts" in text and text.count("atomicAdd(&bitscan_counts") >= 4


def test_breakdown_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bitscan_breakdown.main([]) == 1


def test_usage_reads_registers_and_spills():
    name = "_ZN47_GLOBAL__N__1a2b3c4d_10_bitscan_cu_5e6f7a8b14bit_scan_wgmmaILi4ELb0EEEv14CUtensorMap_stS1_"
    report = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
              f"ptxas info    : Function properties for {name}\n"
              "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
              "ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]\n"
              "ptxas info    : Function properties for _ZN3fooEv\n"
              "ptxas info    : Used 12 registers\n")
    assert bitscan_breakdown.usage(report) == {"bit_scan_wgmma<4, 0>": {"spills": (4, 4), "registers": 255}}
    assert bitscan_breakdown.short("_ZN4anon14bit_scan_mergeEPKfPKiPfPiiii") == "bit_scan_merge"
