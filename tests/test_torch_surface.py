"""Every public name of the JAX package is in the port: each name of
`usearch_tpu.__all__` in `usearch_torch`, each public attribute of
`usearch_tpu.Index` on the port's `Index`, and none of them is a stub (a
placeholder that raises `NotImplementedError` naming a ROADMAP item)."""

import importlib
import inspect

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402

import usearch_torch  # noqa: E402

INDEX_NAMES = sorted(n for n in dir(usearch_tpu.Index) if not n.startswith("_"))


def unported(obj):
    """The stub behind ``obj`` (a function or a class), or None when the
    name is ported."""
    if isinstance(obj, (staticmethod, property)):
        obj = obj.__func__ if isinstance(obj, staticmethod) else obj.fget
    return obj if getattr(obj, "roadmap", None) else None


@pytest.mark.parametrize("name", usearch_tpu.__all__)
def test_package_name(name):
    assert hasattr(usearch_torch, name), f"usearch_torch lacks {name}"
    assert name in usearch_torch.__all__
    assert unported(getattr(usearch_torch, name)) is None, f"usearch_torch.{name} is still a stub"


@pytest.mark.parametrize("name", INDEX_NAMES)
def test_index_name(name):
    static = inspect.getattr_static(usearch_torch.Index, name, None)
    assert static is not None, f"usearch_torch.Index lacks {name}"
    assert unported(static) is None, f"usearch_torch.Index.{name} is still a stub"


def test_ported_names_are_not_stubs():
    """The names the port does carry are the working ones."""
    assert usearch_torch.Key is usearch_tpu.Key
    assert usearch_torch.MetricKindBitwise == (usearch_torch.MetricKind.Hamming, usearch_torch.MetricKind.Tanimoto,
                                               usearch_torch.MetricKind.Sorensen)
    for name in ("DEFAULT_CONNECTIVITY", "DEFAULT_EXPANSION_ADD", "DEFAULT_EXPANSION_SEARCH", "USES_OPENMP",
                 "USES_SIMSIMD", "USES_FP16LIB"):
        assert getattr(usearch_torch, name) == getattr(usearch_tpu, name)
    assert callable(importlib.import_module("usearch_torch.kmeans").kmeans_fit)  # the fit behind `kmeans`
