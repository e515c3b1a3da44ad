"""usearch_torch's `ShardedIndex` across two processes: a gloo group formed
through `parallel.mesh.distributed_initialize`, 4 CPU shards in each, on
the data of tests/multihost_worker.py (512 x 32 rows, l2sq, seed 0, the
first 8 rows as queries, k=5).

Each process builds the same pool and keeps its own 4 shards; the search
merges through one all-gather. The ids are the rows themselves, equal to a
one-process 8-shard search of the port and to the JAX package's
`sharded_search_kernel` on its 8 virtual CPU devices. The two processes
also build the IVF (their layouts gathered), probe it fully, and save the
pool together: the directory loads in one process and searches the same.

The worker is this file run as a script: ``python
tests/test_torch_multihost.py <host:port> <rank> <world> <directory>``.
"""

import os
import socket
import subprocess
import sys

import numpy as np

N, D, K, N_Q = 512, 32, 5, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds each worker may take
TIMEOUT = 120


def data():
    rng = np.random.default_rng(0)  # the same seed everywhere: the same rows
    rows = rng.standard_normal((N, D)).astype(np.float32)
    return rows, rows[:N_Q].copy()


def worker(address: str, rank: int, world: int, out_dir: str) -> None:
    """One process of the group: the exact search, the IVF's full probe
    and a save, the first process writing the ids."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from usearch_torch.parallel.mesh import distributed_initialize, make_mesh
    from usearch_torch.parallel.sharded import ShardedIndex

    distributed_initialize(coordinator_address=address, num_processes=world, process_id=rank, device="cpu")
    try:
        mesh = make_mesh(4, device="cpu")
        assert mesh.shape["shard"] == 4 * world and list(mesh.shard_ids) == list(range(4 * rank, 4 * rank + 4))
        rows, queries = data()
        pool = ShardedIndex.build(rows, metric="l2sq", mesh=mesh)
        exact = pool.search(queries, K)
        pool.optimize(n_partitions=4)
        probed = pool.search(queries, K, expansion_search=100000)
        pool.save(os.path.join(out_dir, "pool"))
        if rank == 0:
            np.savez(os.path.join(out_dir, "ids.npz"), exact=exact.keys, exact_d=exact.distances, probed=probed.keys)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_search(tmp_path):
    import jax
    import jax.numpy as jnp
    from usearch_tpu.enums import MetricKind as JaxMetric, ScalarKind as JaxKind
    from usearch_tpu.ops.distances import row_stats
    from usearch_tpu.parallel.mesh import make_mesh as jax_mesh
    from usearch_tpu.parallel.sharded import sharded_search_kernel

    from usearch_torch.parallel.mesh import make_mesh
    from usearch_torch.parallel.sharded import ShardedIndex

    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), address, str(rank), "2", str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += f"\nkilled after {TIMEOUT} s"
        outputs.append((p.returncode, out))
    assert all(rc == 0 for rc, _ in outputs), "\n".join(out[-2000:] for _, out in outputs)

    got = np.load(tmp_path / "ids.npz")
    np.testing.assert_array_equal(got["exact"][:, 0], np.arange(N_Q))
    rows, queries = data()
    one = ShardedIndex.build(rows, metric="l2sq", mesh=make_mesh(8, device="cpu"))
    want = one.search(queries, K)
    np.testing.assert_array_equal(got["exact"], want.keys)
    np.testing.assert_array_equal(got["exact_d"], want.distances)
    np.testing.assert_array_equal(got["probed"], want.keys)

    stats = row_stats(jnp.asarray(rows), JaxKind.F32)
    _, ids = sharded_search_kernel(jnp.asarray(queries), jnp.asarray(rows), stats, jnp.ones(N, dtype=bool),
                                   metric=JaxMetric.L2sq, kind=JaxKind.F32, ndim=D, k=K, tile_rows=64,
                                   mesh=jax_mesh())
    np.testing.assert_array_equal(np.asarray(jax.device_get(ids)), want.keys.astype(np.int64))

    loaded = ShardedIndex.load(str(tmp_path / "pool"), mesh=make_mesh(8, device="cpu"))
    assert loaded._ivf is not None and len(loaded) == N
    np.testing.assert_array_equal(loaded.search(queries, K, expansion_search=100000).keys, want.keys)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
