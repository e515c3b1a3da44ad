"""Every public name of the JAX package is in the port: each name of
`usearch_tpu.__all__` in `usearch_torch`, each public attribute of
`usearch_tpu.Index` on the port's `Index`. A name the port has not ported
yet raises `NotImplementedError` naming its ROADMAP item when it is called,
constructed or read, never `AttributeError`."""

import importlib
import inspect
import re

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402

import usearch_torch  # noqa: E402

INDEX_NAMES = sorted(n for n in dir(usearch_tpu.Index) if not n.startswith("_"))
ROADMAP_ITEM = re.compile(r"ROADMAP queue [A-C]\.\d+[a-z]?\)")


def unported(obj):
    """The stub behind ``obj`` (a function or a class), or None when the
    name is ported."""
    if isinstance(obj, (staticmethod, property)):
        obj = obj.__func__ if isinstance(obj, staticmethod) else obj.fget
    return obj if getattr(obj, "roadmap", None) else None


def assert_names_its_item(call, item: str):
    with pytest.raises(NotImplementedError) as err:
        call()
    assert ROADMAP_ITEM.search(str(err.value)), str(err.value)
    assert f"queue {item})" in str(err.value)


@pytest.mark.parametrize("name", usearch_tpu.__all__)
def test_package_name(name):
    assert hasattr(usearch_torch, name), f"usearch_torch lacks {name}"
    assert name in usearch_torch.__all__
    stub = unported(getattr(usearch_torch, name))
    if stub is not None:
        assert_names_its_item(getattr(usearch_torch, name), stub.roadmap)


@pytest.mark.parametrize("name", INDEX_NAMES)
def test_index_name(name):
    static = inspect.getattr_static(usearch_torch.Index, name, None)
    assert static is not None, f"usearch_torch.Index lacks {name}"
    stub = unported(static)
    if stub is None:
        return
    index = usearch_torch.Index(ndim=8, device="cpu")
    if isinstance(static, property):
        assert_names_its_item(lambda: getattr(index, name), stub.roadmap)
    else:
        assert_names_its_item(getattr(index, name), stub.roadmap)


def test_ported_names_are_not_stubs():
    """The names the port does carry are the working ones."""
    assert usearch_torch.Key is usearch_tpu.Key
    assert usearch_torch.MetricKindBitwise == (usearch_torch.MetricKind.Hamming, usearch_torch.MetricKind.Tanimoto,
                                               usearch_torch.MetricKind.Sorensen)
    for name in ("DEFAULT_CONNECTIVITY", "DEFAULT_EXPANSION_ADD", "DEFAULT_EXPANSION_SEARCH", "USES_OPENMP",
                 "USES_SIMSIMD", "USES_FP16LIB"):
        assert getattr(usearch_torch, name) == getattr(usearch_tpu, name)
    assert callable(importlib.import_module("usearch_torch.kmeans").kmeans_fit)  # the fit behind the stub
