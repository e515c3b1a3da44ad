"""The tensor-core grouped probe (csrc/probe.cu `grouped_wgmma`, B3 and B5
over i8 and bf16) shares the `wgmma` building blocks of csrc/wgmma_common.cuh,
and each variant of the probe breakdown script still replaces lines of that
kernel (or of a helper it calls), so a change of the kernel cannot leave a
variant timing the full kernel."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from usearch_torch.microbench import probe_breakdown, sass_diff, scan_breakdown  # noqa: E402

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


def test_probe_source_takes_the_shared_headers():
    text = (CSRC / "probe.cu").read_text()
    assert '#include "wgmma_common.cuh"' in text and '#include "probe_common.cuh"' in text
    assert "mma_k(acc, da + 2 * k, db + 2 * k, kb | k)" in _body(text, "grouped_wgmma(const __grid_constant__")


@pytest.mark.parametrize("part", [p for p in probe_breakdown.PARTS if p != "full"])
def test_probe_breakdown_variants_apply(part):
    full = (CSRC / "probe.cu").read_text()
    text = scan_breakdown._variant_source(probe_breakdown.PARTS[part], "probe.cu")
    assert text != full and "grouped_wgmma" in text


@pytest.mark.parametrize("part", [p for p in probe_breakdown.PARTS if p != "full"])
def test_probe_breakdown_variants_reach_the_tensor_core_kernel(part):
    """Every replaced line lies in `grouped_wgmma` or in `probe_release`,
    which it alone calls; no SIMT probe kernel is left for f32 or b1: every
    storage type runs the tensor-core kernel."""
    text = (CSRC / "probe.cu").read_text()
    kernel = _body(text, "grouped_wgmma(const __grid_constant__")
    release = _body(text, "void probe_release(")
    for old, _ in probe_breakdown.PARTS[part]:
        assert old in kernel or old in release, old
    assert "grouped_probe_kernel" not in text


def test_probe_breakdown_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_breakdown.main() == 1


def test_sass_diff_needs_the_other_checkout(capsys):
    assert sass_diff.main([]) == 2
    assert "OTHER_CHECKOUT" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["_GLOBAL__N__d0e1f2a3_8_probe_cu_5a6b7c8d", "_GLOBAL__N__ab12_7_scan_cu_ff00"])
def test_sass_diff_normalises_anonymous_namespaces(name):
    mangled = f"_ZN{len(name)}{name}13grouped_wgmmaIaLi0ELi4ELb1EEEv"
    want = "_ZNANON13grouped_wgmmaIaLi0ELi4ELb1EEEv"
    assert sass_diff.normalise(f"{mangled} {mangled}") == f"{want} {want}"


def test_simt_kernel_keeps_f32_and_b1_only():
    """i8 and bf16 B3/B5 dispatch to the tensor-core kernel and nowhere else:
    no launch of the SIMT template names them."""
    text = (CSRC / "probe.cu").read_text()
    assert not re.search(r"launch_typed<(int8_t|__nv_bfloat16),", text)
    for t in ("int8_t", "__nv_bfloat16"):
        assert f"launch_wgmma<{t}, 4, false>" in text and f"launch_wgmma<{t}, 8, false>" in text
    fold = _body(text, "int launch_fold(")
    assert "launch_wgmma<T, 4, true>" in fold and "launch_wgmma<T, 16, true>" in fold


@pytest.mark.parametrize("part", [p for p in probe_breakdown.PARTS if p != "full"])
def test_probe_breakdown_variants_reach_the_b1_kernel(part):
    """B4 and B5 over packed b1 rows run `grouped_wgmma` apart from i8 in
    their product alone (`if constexpr (kB1)`: the and-popc `mma_popc`), so
    every variant's replaced lines are lines the b1 instantiations run, and
    a variant without the i8 product has no b1 product either: no b1
    variant times the full kernel."""
    text = (CSRC / "probe.cu").read_text()
    kernel = _body(text, "grouped_wgmma(const __grid_constant__")
    assert kernel.count("kB1") == 2 and "if constexpr (kB1) mma_popc(acc, da + 2 * k, db + 2 * k, kb | k)" in kernel
    variant = _body(scan_breakdown._variant_source(probe_breakdown.PARTS[part], "probe.cu"),
                    "grouped_wgmma(const __grid_constant__")
    assert variant != kernel
    assert ("mma_k(" in variant) == ("mma_popc(" in variant)


def test_b1_dispatches_to_the_tensor_core_kernel():
    """b1 B3 and B5 (bin_m 1-16) launch `grouped_wgmma` and never the SIMT
    kernel, which keeps f32 alone; the b1 product is the and-popc form."""
    text = (CSRC / "probe.cu").read_text()
    assert not re.search(r"launch_typed<(uint8_t|int8_t|__nv_bfloat16),", text)
    for n in (8, 16):
        assert f"launch_wgmma<uint8_t, {n}, false>" in text
    fold = _body(text, "int launch_fold(")
    assert "launch_wgmma<T, 4, true>" in fold and "launch_typed" not in text
    header = (CSRC / "wgmma_common.cuh").read_text()
    assert ".m64n128k256.s32.b1.b1.and.popc" in _body(header, "void mma_popc(")
