"""The host-side modules of ROADMAP A.9 on the CPU: `io` (the files byte
for byte, each package reading the other's), `sqlite` (the same SQL
functions with equal values), `eval` (its metrics equal on the same
inputs, `random_vectors` on a `torch.Generator`), `profiling` (a trace
written on `torch.profiler`) and `bench_cli` (``--device cpu`` prints its
line)."""

import json
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from usearch_tpu import eval as jeval  # noqa: E402
from usearch_tpu import io as jio  # noqa: E402
from usearch_tpu import sqlite as jsqlite  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import bench_cli, io, profiling  # noqa: E402
from usearch_torch import eval as teval  # noqa: E402
from usearch_torch import sqlite as tsqlite  # noqa: E402

MATRICES = {".fbin": np.float32, ".f32bin": np.float32, ".dbin": np.float64, ".hbin": np.float16,
            ".ibin": np.int32, ".i32bin": np.int32, ".bbin": np.uint8, ".i8bin": np.int8}


@pytest.mark.parametrize("ext", sorted(MATRICES))
def test_matrix_files_cross_byte_for_byte(tmp_path, ext):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((37, 9)) * 50).astype(MATRICES[ext])
    ours, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    io.save_matrix(x, ours)
    jio.save_matrix(x, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        for view in (False, True):
            np.testing.assert_array_equal(io.load_matrix(path, view=view), jio.load_matrix(path, view=view))
        np.testing.assert_array_equal(io.load_matrix(path, start_row=5, count_rows=7), x[5:12])
    assert io.load_matrix(str(tmp_path / f"missing{ext}")) is None


def test_matrix_errors_as_the_reference(tmp_path):
    path = str(tmp_path / "short.fbin")
    io.save_matrix(np.zeros((4, 4), np.float32), path)
    with open(path, "r+b") as f:
        f.truncate(40)
    for module in (io, jio):
        with pytest.raises(ValueError, match="short"):
            module.load_matrix(path)
    with pytest.raises(ValueError):
        io.save_matrix(np.zeros(4, np.float32), path)
    assert io.guess_numpy_dtype_from_filename("x.unknown") is None


def sql_values(register, calls):
    conn = sqlite3.connect(":memory:")
    register(conn)
    try:
        return [conn.execute(f"SELECT {name}(?, ?)", args).fetchone()[0] for name, args in calls]
    finally:
        conn.close()


def test_sqlite_functions_equal_the_reference():
    rng = np.random.default_rng(2)
    calls = []
    for scalar, dt in (("f32", np.float32), ("f64", np.float64), ("f16", np.float16), ("i8", np.int8)):
        for metric in ("cosine", "sqeuclidean", "inner"):
            a, b = (rng.standard_normal(12) * 20).astype(dt), (rng.standard_normal(12) * 20).astype(dt)
            calls.append((f"distance_{metric}_{scalar}", (a.tobytes(), b.tobytes())))
            calls.append((f"distance_{metric}_{scalar}", (json.dumps(a.tolist()), json.dumps(b.tolist()))))
            calls.append((f"distance_{metric}_{scalar}", (None, b.tobytes())))
    bits = rng.integers(0, 256, (2, 8), dtype=np.uint8)
    calls += [("distance_hamming_binary", (bits[0].tobytes(), bits[1].tobytes())),
              ("distance_jaccard_binary", (bits[0].tobytes(), bits[1].tobytes())),
              ("distance_levenshtein_unicode", ("kitten", "sitting")),
              ("distance_levenshtein_bytes", (b"abc", b"abd")),
              ("distance_hamming_unicode", ("karolin", "kathrin")),
              ("distance_hamming_bytes", (b"abcd", b"abzdx"))]
    got = sql_values(tsqlite.register, calls)
    assert got == sql_values(jsqlite.register, calls)
    assert got[-4:] == [3, 1, 3, 2] and got[2] is None


def test_eval_metrics_equal_the_reference():
    rng = np.random.default_rng(3)
    rel = rng.random(12)
    for k in (None, 5):
        assert teval.dcg(rel, k) == jeval.dcg(rel, k)
        assert teval.ndcg(rel, k) == jeval.ndcg(rel, k)
    expected, predicted = np.arange(10), rng.integers(0, 20, 10)
    assert teval.relevance(expected, predicted, 6) == jeval.relevance(expected, predicted, 6)
    keys = rng.integers(0, 30, (8, 10)).astype(np.uint64)
    counts = rng.integers(0, 11, 8).astype(np.uint64)
    truth = rng.integers(0, 30, (8, 10))
    ours = usearch_torch.BatchMatches(keys=keys, distances=np.zeros((8, 10), np.float32), counts=counts)
    theirs = jax_matches(keys, counts)
    assert teval.recall_at_k(ours, truth, 10) == jeval.recall_at_k(theirs, truth, 10)
    for n_a, r_a, n_b, r_b in ((10, 2.0, 30, 4.0), (None, None, 5, 1.0)):
        assert teval._combine_rates(n_a, r_a, n_b, r_b) == jeval._combine_rates(n_a, r_a, n_b, r_b)


def jax_matches(keys, counts):
    import usearch_tpu

    return usearch_tpu.BatchMatches(keys=keys, distances=np.zeros(keys.shape, np.float32), counts=counts)


def test_random_vectors_and_evaluation():
    """`random_vectors` lays rows out as the JAX package's do, and repeats
    for a seed; an evaluation runs on a port index."""
    for metric, dtype, ndim, want in (("ip", "f32", 16, np.float32), ("l2sq", "i8", 16, np.int8),
                                      ("hamming", "b1", 20, np.uint8), ("cos", "f16", 8, np.float16)):
        ours = teval.random_vectors(30, metric, dtype, ndim, seed=4)
        theirs = jeval.random_vectors(30, metric, dtype, ndim)
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == want
        np.testing.assert_array_equal(ours, teval.random_vectors(30, metric, dtype, ndim, seed=4))
    unit = teval.random_vectors(10, "ip", "f32", 16)
    np.testing.assert_allclose(np.linalg.norm(unit, axis=1), 1.0, rtol=1e-6)
    assert not (teval.random_vectors(4, "l2sq", "f32", 8) == teval.random_vectors(4, "l2sq", "f32", 8)).all()

    data = teval.Dataset.build(count=300, ndim=8, k=5, metric="l2sq", device="cpu")
    index = usearch_torch.Index(ndim=8, metric="l2sq", dtype="f32", device="cpu")
    result = teval.Evaluation.for_dataset(data, batch_size=100)(index)
    assert result["add_operations"] == 300 and result["search_operations"] == 30
    assert result["recall_at_one"] == 1.0 and len(index) == 0
    index.add(None, data.vectors)
    stats = teval.self_recall(index, sample=1.0)
    assert stats.mean_recall == 1.0 and stats.count_queries == 300
    index.optimize(n_partitions=4)
    curve = teval.probe_curve(index, data.queries, 5, expansions=[4, 64])
    assert [p["nprobe"] for p in curve] == sorted(p["nprobe"] for p in curve) and curve[-1]["recall"] == 1.0


def test_profiling_trace_on_the_cpu(tmp_path):
    index = usearch_torch.Index(ndim=8, metric="l2sq", dtype="f32", device="cpu")
    index.add(None, np.random.default_rng(5).standard_normal((64, 8)).astype(np.float32))
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("test-span"):
            index.search(np.zeros(8, np.float32), 3)
    trace = tmp_path / "trace" / "trace.json"
    assert trace.is_file() and "test-span" in trace.read_text()
    assert any(ev.key == "test-span" for ev in prof.key_averages())
    assert isinstance(profiling.device_memory_stats(), dict)


def test_bench_cli_prints_its_line(tmp_path, capsys):
    bench_cli.main(["--synthetic", "2000", "--ndim", "16", "--batch", "128", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["vectors"] == 2000 and report["device"] == "cpu"
    assert report["qps"] > 0 and report["add_per_second"] > 0

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((500, 16)).astype(np.float32)
    gt = usearch_torch.exact_search(vecs, vecs[:32], 10, metric="ip", device="cpu").keys.astype(np.int32)
    paths = {name: str(tmp_path / name) for name in ("base.fbin", "q.fbin", "gt.ibin")}
    for name, arr in zip(paths, (vecs, vecs[:32], gt)):
        io.save_matrix(arr, paths[name])
    bench_cli.main(["--vectors", paths["base.fbin"], "--queries", paths["q.fbin"], "--neighbors", paths["gt.ibin"],
                    "--metric", "ip", "--quantization", "f32", "-k", "10", "--ivf", "--reorder", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["recall_at_k"] > 0.9 and report["recall_at_1"] > 0.9


def test_new_entry_points_take_the_card_by_default():
    """Without ``device="cpu"`` the new entry points ask for the card: with
    none present they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError):
        bench_cli.main(["--synthetic", "100", "--ndim", "8"])
    with pytest.raises(RuntimeError):
        teval.Dataset.build(count=20, ndim=4)
    with pytest.raises(RuntimeError):
        teval.AddTask(keys=np.arange(20), vectors=np.zeros((20, 4), np.float32)).clusters(2)
