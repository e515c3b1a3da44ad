"""The port stands alone: no file of usearch_torch, nor chip_smoke.py,
imports JAX or the JAX package, and its entry points run on the card
unless asked for the CPU."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "usearch_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "usearch_tpu")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import numpy as np

    import usearch_torch
    from usearch_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError):
        usearch_torch.Index(ndim=8)
    with pytest.raises(RuntimeError):
        usearch_torch.exact_search(np.zeros((4, 8), np.float32), np.zeros((1, 8), np.float32), 1)
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        usearch_torch.ShardedIndex.build(np.zeros((4, 8), np.float32))
    assert len(usearch_torch.Index(ndim=8, device="cpu")) == 0
    assert len(usearch_torch.ShardedIndex.build(np.zeros((4, 8), np.float32), mesh=make_mesh(2, device="cpu"))) == 4


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No result line, and a non-zero exit, without a card or outside a
    checkout of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    run = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
