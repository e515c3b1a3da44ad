"""usearch_torch.ops against usearch_tpu.ops on the CPU: the i8 quantizer,
row stats, the metric epilogues and the top-k helpers, on the same numpy
inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.enums import ScalarKind as JKind  # noqa: E402
from usearch_tpu.ops import casts as jcasts  # noqa: E402
from usearch_tpu.ops import distances as jdist  # noqa: E402
from usearch_tpu.ops import pallas_scan as jscan  # noqa: E402
from usearch_tpu.ops import topk as jtopk  # noqa: E402

from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.ops import casts, distances, topk  # noqa: E402

METRICS = ["ip", "cos", "l2sq"]
DTYPES = ["i8", "bf16", "f32"]
_JAX_DTYPES = {"i8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}
_TORCH_DTYPES = {"i8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def rows(rng, n, w, dtype, zeros=2):
    """The same rows as a JAX array and a tensor; the first ``zeros`` are
    zero rows (cos's zero-norm rules)."""
    if dtype == "i8":
        x = rng.integers(-127, 128, (n, w)).astype(np.int8)
    else:
        x = rng.standard_normal((n, w)).astype(np.float32)
    x[:zeros] = 0
    j = jnp.asarray(x, _JAX_DTYPES[dtype])
    t = torch.from_numpy(x).to(_TORCH_DTYPES[dtype])
    if dtype == "bf16":  # both round f32 to bf16 to nearest even
        np.testing.assert_array_equal(np.asarray(j).view(np.int16), t.view(torch.int16).numpy())
    return j, t


def test_i8_quantizer_matches_reference():
    """The torch quantizer agrees with the reference's numpy body in at
    least 99.9% of entries and is never more than 1 apart: f32 norms summed
    in another order may move a value across a truncation boundary."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    x[0] = 0  # zero row
    x[1] *= 1e30  # rescaled before squaring: no overflow
    x[2, :] = 0
    x[2, 7] = -3.0  # one nonzero: -127 exactly
    want = jcasts._i8_quantize(x, np)
    got = casts._i8_quantize(torch.from_numpy(x)).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999
    np.testing.assert_array_equal(got[:3], want[:3])


def test_i8_host_cast_matches_reference_bit_for_bit():
    """Host batches take the native cast (native/casts.cc), the JAX
    package's own host route: equal to it bit for bit, the edge rows of the
    test above included."""
    assert casts.NATIVE
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    x[0] = 0
    x[1] *= 1e30
    x[2, :] = 0
    x[2, 7] = -3.0
    got = casts.cast_vectors(x, ScalarKind.F32, ScalarKind.I8).numpy()
    np.testing.assert_array_equal(got, jcasts.cast_to_i8_np(x))


@pytest.mark.parametrize("to_kind", ["f32", "f16", "bf16", "i8"])
def test_cast_vectors_matches_reference(to_kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    got = casts.cast_vectors(x, ScalarKind.F32, ScalarKind(to_kind))
    want = np.asarray(jcasts.cast_vectors(x, JKind.F32, JKind(to_kind), 48))
    if to_kind == "bf16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif to_kind == "i8":
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
        back = casts.cast_vectors(got.numpy(), ScalarKind.I8, ScalarKind.F32).numpy()
        np.testing.assert_array_equal(back, jcasts.cast_from_i8_np(got.numpy()))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_stats(dtype):
    rng = np.random.default_rng(2)
    j, t = rows(rng, 300, 256, dtype)
    want = np.asarray(jdist.row_stats(j, JKind(dtype)))
    got = distances.row_stats(t, ScalarKind(dtype)).numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    # sums cancel: f32 sums of 256 unit-scale terms in another order differ
    # by up to ~W * eps * max|x| in absolute terms
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=5e-5)
    if dtype == "i8":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", METRICS + ["pearson"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_epilogues(metric, dtype):
    """The same dots and stats through both epilogues, zero-norm rows and
    queries included."""
    rng = np.random.default_rng(3)
    jq, tq = rows(rng, 40, 128, dtype)
    jt, tt = rows(rng, 200, 128, dtype, zeros=3)
    q_stats = np.array(jdist.row_stats(jq, JKind(dtype)))
    t_stats = np.array(jdist.row_stats(jt, JKind(dtype)))
    dots = np.array(jdist._dot(jq, jt)).astype(np.float32)
    want = np.asarray(jdist.dot_metric_dists(JMetric(metric), jnp.asarray(dots), q_stats, t_stats, 128))
    got = distances.dot_metric_dists(
        MetricKind(metric), torch.from_numpy(dots), torch.from_numpy(q_stats), torch.from_numpy(t_stats), 128
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if dtype == "i8":
        np.testing.assert_array_equal(got, want)
    # the full tile path, dots included
    got = distances.tile_dists(MetricKind(metric), ScalarKind(dtype), tq, torch.from_numpy(q_stats),
                               tt, torch.from_numpy(t_stats), 128).numpy()
    want = np.asarray(jdist.tile_dists(JMetric(metric), JKind(dtype), jq, q_stats, jt, t_stats, 128))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_scan_epilogue_matches_kernel_epilogue(metric, shifted):
    """The scan kernels' epilogue (with the deleted-row penalty) against the
    TPU kernel's `_epilogue_t`, fed the same dots; the JAX one works on the
    transposed [rows, queries] layout."""
    rng = np.random.default_rng(4)
    jq, tq = rows(rng, 32, 128, "i8")
    jt, tt = rows(rng, 256, 128, "i8", zeros=3)
    dots = np.array(jdist._dot(jq, jt)).astype(np.float32)  # [Q, T]
    q_sq = np.array(jdist.row_stats(jq, JKind.I8))[:, 0]
    stats = np.array(jdist.row_stats(jt, JKind.I8))
    penalty = np.where(rng.random(256) < 0.1, np.float32(jdist.MASKED), np.float32(0))
    q_aux = np.stack([q_sq, np.zeros_like(q_sq)])
    t_aux = np.stack([stats[:, 0], stats[:, 1], penalty, np.zeros_like(penalty)])
    want = np.asarray(jscan._epilogue_t(JMetric(metric), jnp.asarray(dots.T), q_aux, t_aux, shifted)).T
    got = distances.scan_epilogue(MetricKind(metric), torch.from_numpy(dots), torch.from_numpy(q_sq),
                                  torch.from_numpy(stats[:, 0].copy()), torch.from_numpy(penalty), shifted)
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_topk_and_merge():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((16, 500)).astype(np.float32)
    valid = rng.random(500) > 0.3
    jd, ji = jtopk.masked_topk(jnp.asarray(d), jnp.asarray(valid), 10)
    td, ti = topk.masked_topk(torch.from_numpy(d), torch.from_numpy(valid), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # everything masked: MASKED distances and id -1
    td, ti = topk.masked_topk(torch.from_numpy(d[:, :5]), torch.zeros(5, dtype=torch.bool), 3)
    assert np.all(ti.numpy() == -1) and np.all(td.numpy() >= jdist.MASKED / 2)
    a, b = d[:, :8], d[:, 8:16]
    ia, ib = np.arange(8)[None].repeat(16, 0), np.arange(8, 16)[None].repeat(16, 0)
    jm = jtopk.merge_topk(jnp.asarray(a), jnp.asarray(ia), jnp.asarray(b), jnp.asarray(ib), 5)
    tm = topk.merge_topk(*(torch.from_numpy(x) for x in (a, ia, b, ib)), 5)
    np.testing.assert_array_equal(tm[1].numpy(), np.asarray(jm[1]))


def test_sort_pairs_breaks_ties_by_id():
    d = torch.tensor([[1.0, 0.5, 1.0, 0.5]])
    ids = torch.tensor([[9, 7, 3, 8]])
    sd, si = topk.sort_pairs(d, ids)
    assert si.tolist() == [[7, 8, 3, 9]] and sd.tolist() == [[0.5, 0.5, 1.0, 1.0]]


@pytest.mark.parametrize("metric", METRICS)
def test_scan_topk_matches_reference(metric):
    """The plain tiled scan against the JAX one, exact mode."""
    rng = np.random.default_rng(6)
    jq, tq = rows(rng, 16, 128, "f32", zeros=0)  # no zero queries: all-tied rows
    jt, tt = rows(rng, 4096, 128, "f32")
    valid = rng.random(4096) > 0.2
    js = jdist.row_stats(jt, JKind.F32)
    jqs = jdist.row_stats(jq, JKind.F32)
    jd, ji = jtopk.scan_topk(JMetric(metric), JKind.F32, jq, jqs, jt, js, jnp.asarray(valid), 10, 1024, 128)
    td, ti = topk.scan_topk(MetricKind(metric), ScalarKind.F32, tq, torch.from_numpy(np.array(jqs)), tt,
                            torch.from_numpy(np.array(js)), torch.from_numpy(valid), 10, 1024, 128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
