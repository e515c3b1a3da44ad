"""The serving layer: the HTTP server and client (server.py, client.py) and
the binary RPC server and client (rpc.py), each against its own package and
across packages both ways (the JAX package's server with the port's client,
and the port's server with the JAX package's client). Every socket has a
timeout and every server stops in a fixture's teardown."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402
from usearch_tpu import client as jclient  # noqa: E402
from usearch_tpu import rpc as jrpc  # noqa: E402
from usearch_tpu import server as jserver  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import client, rpc, server  # noqa: E402

TIMEOUT = 10.0
PORT = (usearch_torch, server, client, rpc)
JAX = (usearch_tpu, jserver, jclient, jrpc)


def new_index(package):
    if package is usearch_torch:
        return usearch_torch.Index(ndim=8, metric="l2sq", dtype="f32", device="cpu")
    return usearch_tpu.Index(ndim=8, metric="l2sq", dtype="f32")


@pytest.fixture(params=[(PORT, PORT), (PORT, JAX), (JAX, PORT)], ids=["port-port", "port-jax", "jax-port"])
def http(request):
    """(server-side index, client): the server of the first package, the
    client of the second."""
    (pkg, srv_mod, _, _), (_, _, cli_mod, _) = request.param
    index = new_index(pkg)
    srv = srv_mod.IndexServer(index, port=0).start()
    try:
        yield index, cli_mod.IndexClient(port=srv.port, timeout=TIMEOUT)
    finally:
        srv.stop()


@pytest.fixture(params=[(PORT, PORT), (PORT, JAX), (JAX, PORT)], ids=["port-port", "port-jax", "jax-port"])
def binary(request):
    (pkg, _, _, srv_rpc), (_, _, _, cli_rpc) = request.param
    index = new_index(pkg)
    srv = srv_rpc.BinaryIndexServer(index, port=0).start()
    try:
        cli = cli_rpc.BinaryIndexClient(port=srv.port, timeout=TIMEOUT)
        try:
            yield index, cli
        finally:
            cli.close()
    finally:
        srv.stop()


def test_http_round_trip(http, rng):
    index, cli = http
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    assert len(cli.add(np.arange(20), vecs)) == 20
    assert len(cli) == 20 and cli.info["ndim"] == 8 and cli.info["metric"] == "l2sq"
    m = cli.search(vecs[:3], 5)
    np.testing.assert_array_equal(m.keys[:, 0], [0, 1, 2])
    assert np.all(m.counts == 5)
    want = index.search(vecs[:3], 5)
    np.testing.assert_array_equal(m.keys, want.keys)
    np.testing.assert_array_equal(m.distances, want.distances)
    np.testing.assert_allclose(np.asarray(cli.get(np.array([4])))[0], vecs[4], atol=1e-6)
    assert cli.contains(np.array([4, 99])).tolist() == [True, False]
    assert cli.remove(np.array([4])).tolist() == [1]
    assert len(cli) == 19 and not index.contains(4)
    with pytest.raises(RuntimeError):
        cli._call("no_such_method")


def test_binary_round_trip(binary, rng):
    index, cli = binary
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    assert len(cli.add(np.arange(20), vecs)) == 20
    assert len(cli) == 20 and cli.info()["ndim"] == 8
    m = cli.search(vecs[:3], 5)
    np.testing.assert_array_equal(m.keys[:, 0], [0, 1, 2])
    assert np.all(m.counts == 5)
    assert cli.search(vecs[0], 3).keys[0] == 0  # one query unwraps to Matches
    np.testing.assert_allclose(np.asarray(cli.get(np.array([4])))[0], vecs[4], atol=1e-6)
    assert cli.contains(np.array([4, 99])).tolist() == [True, False]
    assert cli.remove(np.array([4])).tolist() == [1]
    assert len(cli) == 19 and not index.contains(4)
    with pytest.raises(RuntimeError):  # an error keeps the connection
        cli.add(np.arange(3), rng.standard_normal((3, 5)).astype(np.float32))
    assert len(cli) == 19


def test_pipelined_search(binary):
    """The JAX package's case: many requests in flight on one connection,
    responses in order, a mutating barrier between bursts, an error inside
    the pipeline raised; each response as the index's own search of it."""
    index, cli = binary
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((512, 8)).astype(np.float32)
    index.add(np.arange(512, dtype=np.uint64), vecs)
    res = cli.search_pipelined([vecs[i : i + 1] for i in range(24)], count=3)
    assert len(res) == 24
    for i, bm in enumerate(res):
        assert int(np.asarray(bm.keys)[0, 0]) == i
        np.testing.assert_array_equal(bm.distances, index.search(vecs[i : i + 1], 3).distances)
    assert cli.contains([5])[0]
    assert int(np.asarray(cli.search_pipelined([vecs[7:8]], count=1)[0].keys)[0, 0]) == 7
    with pytest.raises(RuntimeError):
        cli.search_pipelined([np.zeros((1, 7), np.float32)], count=1)


def test_pipelined_search_past_the_depth():
    """More requests than the pipeline's depth over a port server: the
    client drains as it sends, and every response comes back in order."""
    index = usearch_torch.Index(ndim=16, metric="ip", dtype="i8", device="cpu")
    vecs = np.random.default_rng(9).standard_normal((300, 16)).astype(np.float32)
    index.add(None, vecs)
    srv = rpc.BinaryIndexServer(index, port=0).start()
    try:
        with rpc.BinaryIndexClient(port=srv.port, timeout=TIMEOUT) as cli:
            res = cli.search_pipelined([vecs[i : i + 1] for i in range(2 * rpc._PIPELINE_DEPTH + 5)], count=2)
    finally:
        srv.stop()
    want = index.search(vecs[: len(res)], 2)
    np.testing.assert_array_equal(np.vstack([r.keys for r in res]), want.keys)
    np.testing.assert_array_equal(np.vstack([r.distances for r in res]), want.distances)


@pytest.mark.parametrize("dtype", [dt.name for dt in jrpc._DTYPES])
def test_pack_array_bytes_as_jax(dtype, rng):
    """`pack_array` writes the JAX package's bytes for every wire dtype, and
    each package unpacks the other's."""
    arr = (rng.standard_normal((3, 5)) * 50).astype(dtype)
    assert [dt.name for dt in rpc._DTYPES] == [dt.name for dt in jrpc._DTYPES]
    assert rpc.pack_array(arr) == jrpc.pack_array(arr)
    for unpack, pack in ((rpc.unpack_array, jrpc.pack_array), (jrpc.unpack_array, rpc.pack_array)):
        got = unpack(pack(arr))
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == arr.dtype


def test_pack_array_bfloat16_as_jax():
    """bf16 arrays travel as f32 in both packages."""
    arr = np.asarray(jax.numpy.arange(6, dtype=jax.numpy.bfloat16).reshape(2, 3))
    assert rpc.pack_array(arr) == jrpc.pack_array(arr)
    assert rpc.unpack_array(rpc.pack_array(arr)).dtype == np.float32


def test_http_arrays_as_jax(rng):
    """The JSON envelope's base64 arrays, byte for byte."""
    arr = rng.standard_normal((4, 3)).astype(np.float32)
    assert server.encode_array(arr) == jserver.encode_array(arr)
    np.testing.assert_array_equal(server.decode_array(jserver.encode_array(arr)), arr)
