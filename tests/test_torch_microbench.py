"""Kernels B11, B12 and B13 (`usearch_torch.ops.microbench`) on the CPU,
where their plain versions run, against the three Pallas kernels of
`scripts/` run in interpret mode, and the micro-benchmark modules.

The TPU scripts run their benchmarks when imported, so the tests never
import them: each kernel's functions are lifted from the script's source
(`ast`) and run in a namespace of small module constants, where
``pl.pallas_call`` runs in interpret mode.

Tolerances: B11 bit for bit in every mode (each step's product is an exact
integer, ``acc`` rounds once a step, in step order), also past 2**24; B12
bit for bit except ``f32_min32`` and ``f32_minarg32``, whose f32 sums of 44
group minima of up to ~8.4e7 follow the reduction order (XLA's is not the
port's sequential one): 1e-6 relative; B13 bit for bit (exact i32 dots,
f32 sums taken window by window as the TPU kernel takes them), with
``dot_only`` also from ``init=0``, since from ``MASKED`` every entry stays
``MASKED`` whatever the dots are.
"""

import ast
import functools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from usearch_tpu.ops.distances import MASKED as JMASKED  # noqa: E402

from usearch_torch.microbench import i8_matmul_probe, probe_v2_bisect, select_microbench  # noqa: E402
from usearch_torch.ops import microbench as mb  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
#: f32 sums of group minima in another order
SUM_RTOL = 1e-6


def interpreted_pallas():
    """``pl`` with ``pallas_call`` in interpret mode."""
    shim = SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return shim


def lift(script: str, names, **consts) -> dict:
    """The named top-level functions of ``scripts/<script>``, defined in a
    namespace holding ``consts`` in place of the module's globals."""
    path = SCRIPTS / script
    tree = ast.parse(path.read_text(), filename=str(path))
    body = [node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name in names]
    assert {node.name for node in body} == set(names)
    ns = dict(jax=jax, jnp=jnp, np=np, pl=interpreted_pallas(), pltpu=pltpu, functools=functools, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


# ---------------------------------------------------------------------------
# B11
# ---------------------------------------------------------------------------

#: (M, K, N, REPS): the accumulators pass 2**24 at 512 steps, not at 24
LOOP_SHAPES = [(32, 64, 128, 512), (16, 64, 64, 24)]


@pytest.mark.parametrize("mode", list(mb.LOOP_MODES))
@pytest.mark.parametrize("shape", LOOP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_loop_matmul_matches_pallas(shape, mode):
    m, k, n, reps = shape
    ns = lift("tpu_i8_matmul_probe.py", ("dot", "pallas_loop"), M=m, K=k, N=n, REPS=reps)
    rng = np.random.default_rng(m + reps)
    a = rng.integers(-127, 127, (m, k)).astype(np.int8)  # a + 1 stays an i8
    b = rng.integers(-127, 127, (n, k)).astype(np.int8)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if mode == "bf16":
        ja, jb, ta, tb = ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16), ta.bfloat16(), tb.bfloat16()
    want = np.asarray(ns["pallas_loop"](mode)(ja, jb))
    before = mb.loop_matmul.launches
    got = mb.loop_matmul(ta, tb, mode, reps).numpy()
    assert mb.loop_matmul.launches == before  # the CPU runs the plain version
    assert got.dtype == want.dtype and got.shape == want.shape == (m, n)
    np.testing.assert_array_equal(got, want)
    if reps == 512:
        assert np.abs(want).max() > 2**24  # f32 rounding of acc is exercised


def test_loop_matmul_refuses():
    a8, b8 = torch.zeros((16, 64), dtype=torch.int8), torch.zeros((64, 64), dtype=torch.int8)
    with pytest.raises(ValueError):
        mb.loop_matmul(a8, b8, "f16", 2)
    with pytest.raises(TypeError):
        mb.loop_matmul(a8, b8, "bf16", 2)
    with pytest.raises(ValueError):
        mb.loop_matmul(a8, b8[:, :32], "i8", 2)
    with pytest.raises(ValueError):  # K past 1,024: sums would leave f32's integers
        mb.loop_matmul(torch.zeros((16, 2048), dtype=torch.int8), torch.zeros((2048, 2048), dtype=torch.int8),
                       "i8", 1)


# ---------------------------------------------------------------------------
# B12
# ---------------------------------------------------------------------------

SELECT_W, SELECT_G, SELECT_IT = 1408, 128, 200


@pytest.fixture(scope="module")
def select_buffer():
    return np.random.default_rng(0).integers(-2_000_000, 2_000_000, (SELECT_W, SELECT_G), dtype=np.int32)


@pytest.mark.parametrize("variant", list(mb.SELECT_VARIANTS))
def test_select_loop_matches_pallas(select_buffer, variant):
    ns = lift("tpu_select_microbench.py", ("make",), W=SELECT_W, G=SELECT_G, IT=SELECT_IT)
    call = pl.pallas_call(ns["make"](variant), out_shape=jax.ShapeDtypeStruct((8, SELECT_G), jnp.float32),
                          in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                          out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    want = np.asarray(call(jnp.asarray(select_buffer)))[0]  # rows 1-7 are never written
    before = mb.select_loop.launches
    got = mb.select_loop(torch.from_numpy(select_buffer), variant, SELECT_IT).numpy()
    assert mb.select_loop.launches == before
    assert got.shape == (8, SELECT_G) and not got[1:].any()
    if variant in ("f32_min32", "f32_minarg32"):
        np.testing.assert_allclose(got[0], want, rtol=SUM_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got[0], want)


def test_select_loop_keeps_the_last_pass(select_buffer):
    x = torch.from_numpy(select_buffer)
    for variant in mb.SELECT_VARIANTS:
        np.testing.assert_array_equal(mb.select_loop(x, variant, 7).numpy(), mb.select_loop(x + 6, variant, 1).numpy())


def test_select_loop_refuses():
    with pytest.raises(ValueError):
        mb.select_loop(torch.zeros((100, 128), dtype=torch.int32), "i32_min32", 2)
    with pytest.raises(ValueError):
        mb.select_loop(torch.zeros((128, 128), dtype=torch.float32), "i32_min32", 2)
    with pytest.raises(ValueError):
        mb.select_loop(torch.zeros((128, 128), dtype=torch.int32), "min", 2)


# ---------------------------------------------------------------------------
# B13
# ---------------------------------------------------------------------------

#: (N, D, C, Q, NPROBE): 256 pairs in two cells of 128, w_pad 512
BISECT = dict(n=19_200, d=32, c=64, q=64, nprobe=4)


@pytest.fixture(scope="module")
def bisect_case():
    """The lifted `build` and `make_kernel` over a small table, the layout
    of the first build, and the port's `Layout` of the same shape."""
    lay = probe_v2_bisect.Layout(**BISECT)
    rng = np.random.default_rng(0)
    table = rng.integers(-127, 128, (lay.cap2, lay.d), dtype=np.int8)
    ns = lift("tpu_probe_v2_bisect.py", ("build", "make_kernel"), N=lay.n, D=lay.d, C=lay.c, Q=lay.q, G=128,
              NPROBE=lay.nprobe, clen=lay.clen, cap2=lay.cap2, w_pad=lay.w_pad, rng=rng,
              table=jnp.asarray(table), starts=lay.starts, MASKED=JMASKED)
    q_g, qa, meta, windows = ns["build"](1)
    return SimpleNamespace(ns=ns, lay=lay, table=table, q_g=np.asarray(q_g), qa=np.asarray(qa), meta=np.asarray(meta),
                           windows=windows)


def pallas_bisect(case, variant: str, init: float) -> np.ndarray:
    """The script's `run` call of the lifted kernel, in interpret mode;
    ``init`` replaces MASKED as the accumulators' start."""
    lay, g = case.lay, 128
    kern = lift("tpu_probe_v2_bisect.py", ("make_kernel",), G=g, w_pad=lay.w_pad, MASKED=init)["make_kernel"]
    f = pl.pallas_call(
        kern(variant, lay.out_pad),
        grid=(lay.q * lay.nprobe // g,),
        in_specs=[
            pl.BlockSpec((1, 8, g), lambda i: (i, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((g, lay.d), lambda i: (i, 0)),
            pl.BlockSpec((g, 8), lambda i: (i, 0)),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((g, lay.out_pad), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((lay.q * lay.nprobe, lay.out_pad), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((2, lay.w_pad, lay.d), jnp.int8),
            pltpu.VMEM((lay.out_pad, g), jnp.float32),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(case.meta), jnp.asarray(case.q_g), jnp.asarray(case.qa), jnp.asarray(case.table)))


@pytest.mark.parametrize("variant,init", [(v, MASKED) for v in mb.BISECT_VARIANTS] + [("dot_only", 0.0)],
                         ids=[*mb.BISECT_VARIANTS, "dot_only-init0"])
def test_bisect_probe_matches_pallas(bisect_case, variant, init):
    want = pallas_bisect(bisect_case, variant, init)
    c, lay = bisect_case, bisect_case.lay
    before = mb.bisect_probe.launches
    got = mb.bisect_probe(torch.from_numpy(c.meta), torch.from_numpy(c.q_g), torch.from_numpy(c.qa),
                          torch.from_numpy(c.table), variant, lay.w_pad, lay.out_pad, init=init).numpy()
    assert mb.bisect_probe.launches == before
    assert got.shape == want.shape == (lay.q * lay.nprobe, lay.out_pad)
    np.testing.assert_array_equal(got, want)
    if variant == "dot_only" and init == 0.0:
        assert got[:, :8].all() and not got[:, 8:].any()  # the dots themselves, summed over the windows
    if variant != "dot_only":
        assert (got < MASKED / 2).sum() == lay.q * lay.nprobe * mb.bisect_bins(variant, lay.w_pad)


def test_bisect_layout_is_the_scripts(bisect_case):
    """probe_v2_bisect's copy of the script's `build` gives the script's arrays
    from the same generator state."""
    lay = bisect_case.lay
    rng = np.random.default_rng(0)
    rng.integers(-127, 128, (lay.cap2, lay.d), dtype=np.int8)  # the table comes first
    got = lay.build(1, rng)
    want = (bisect_case.q_g, bisect_case.qa, bisect_case.meta, bisect_case.windows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bisect_skips_windows_outside_the_table(bisect_case):
    c, lay = bisect_case, bisect_case.lay
    meta = c.meta.copy()
    meta[0, 0, 0] = lay.cap2  # the first window of cell 0 past the end
    got = mb.bisect_probe(torch.from_numpy(meta), torch.from_numpy(c.q_g), torch.from_numpy(c.qa),
                          torch.from_numpy(c.table), "sel8", lay.w_pad, lay.out_pad).numpy()
    own0 = c.qa[:128, 2] == 0
    assert own0.any() and (got[:128][own0] == MASKED).all() and (got[:128][~own0, :64] < MASKED).all()


def test_bisect_probe_refuses(bisect_case):
    c, lay = bisect_case, bisect_case.lay
    args = [torch.from_numpy(x) for x in (c.meta, c.q_g, c.qa, c.table)]
    with pytest.raises(ValueError):  # sel8 keeps w_pad / 8 = 64 entries
        mb.bisect_probe(*args, "sel8", lay.w_pad, 32)
    with pytest.raises(ValueError):
        mb.bisect_probe(*args, "sel8", 100, lay.out_pad)
    with pytest.raises(ValueError):
        mb.bisect_probe(*args, "select", lay.w_pad, lay.out_pad)


# ---------------------------------------------------------------------------
# the benchmark modules
# ---------------------------------------------------------------------------

#: module constants that cut each benchmark to a small shape on the CPU
SMALL = {
    "i8_matmul_probe": dict(M=16, K=64, N=64, REPS=4),
    "select_microbench": dict(W=256, G=32, IT=3),
    "probe_v2_bisect": dict(N=BISECT["n"], D=BISECT["d"], C=BISECT["c"], Q=BISECT["q"], NPROBE=BISECT["nprobe"]),
}
MAINS = {"i8_matmul_probe": i8_matmul_probe, "select_microbench": select_microbench,
         "probe_v2_bisect": probe_v2_bisect}


@pytest.mark.parametrize("name", list(MAINS))
def test_benchmark_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        MAINS[name].main()


@pytest.mark.parametrize("name", list(MAINS))
def test_benchmark_prints_the_scripts_lines_on_the_cpu(name, capsys, monkeypatch):
    for const, value in SMALL[name].items():
        monkeypatch.setattr(MAINS[name], const, value)
    lines = MAINS[name].main(device="cpu")
    assert capsys.readouterr().out.splitlines() == lines
    if name == "i8_matmul_probe":
        assert [ln[:32].strip() for ln in lines] == [name for name, _, _ in i8_matmul_probe.LOOP_LINES]
        assert all(ln.split()[-3] == "T(FL)OPS" for ln in lines)
    elif name == "select_microbench":
        assert [ln.split(":")[0].strip() for ln in lines] == list(mb.SELECT_VARIANTS)
        assert all(ln.endswith("us/iter") for ln in lines)
    else:
        assert [ln.split(":")[0].strip() for ln in lines] == list(mb.BISECT_VARIANTS)
        assert all("us/window, windows=" in ln for ln in lines)
