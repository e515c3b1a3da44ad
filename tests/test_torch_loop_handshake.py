"""Kernel B11's step-to-step handshake (csrc/matmul_probe.cu `loop_wgmma`) in
a host model kept here, run under many seeded random interleavings of the
blocks' steps, and the shapes the tensor-core kernel admits beyond the old
ones against the plain version and the Pallas kernel in interpret mode.

The model follows the kernel. Block (x, y) owns rows [64 y, 64 y + 64) of
``acc`` and the columns of `loop_layout`'s blocks; the lead blocks (columns
starting below K) make the parity of ``acc[:, :K]``. Each step, while the
other warps build A from the bits in one of the block's two shared
buffers, warp 0 does the handshake: a lead block alone in its row tile
raises flag s - 1 (its bits of step s - 1 were stored the step before); a
block that is not a lead waits until flag s counts every lead block. Then
the block issues its product, and:
- a block that is not a lead copies bits[s] into its other buffer while
  its product runs;
- after the product, a lead block stores its words of bits[s] (to global
  memory and its other buffer); where several lead blocks share the row
  tile, each raises flag s, waits for all of them and copies the others'
  words.
The asserts: no block reads bits[s] before every lead block of its row
tile has stored its words there; no global buffer is stored twice, and no
shared buffer is refilled while the step that needs it has not read it; no
interleaving deadlocks; ``acc`` equals `loop_matmul_plain` bit for bit (the
model's arithmetic is the plain version's, block by block: a in its own
arithmetic, each step's product exact, acc rounded once a step)."""

import ast
import functools
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from usearch_torch.microbench import loop_breakdown  # noqa: E402
from usearch_torch.ops import microbench as mb  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
MODES = list(mb.LOOP_MODES)
#: an H100's SMs: `loop_layout`'s blocks for the card
SMS = 132
#: (M, K, N, steps): LOOP_CHECK's shapes and the script's at fewer steps; K
#: spanning two and sixteen lead blocks (48 x 512, 16 x 1024); 64-column
#: warpgroups (N = 192)
HANDSHAKE_SHAPES = [(32, 64, 128, 12), (64, 128, 256, 9), (256, 256, 1024, 6), (48, 512, 512, 6), (80, 64, 192, 8),
                    (16, 1024, 1024, 4), (256, 256, 8192, 3)]
#: interleavings a shape and mode
ORDERS = 6
#: the kernel's new shapes: rows padded inside a 64-row tile (48, 80), K = N;
#: the second passes 2**24 at 512 steps
PAD_SHAPES = [(48, 128, 128, 40), (80, 64, 64, 512)]

SPIN = "spin"


class Card:
    """The device state the blocks share: bits[s] by step, the flags, acc."""

    def __init__(self, a, b, mode: str, reps: int):
        self.a, self.b, self.mode, self.reps = a, b, mode, reps
        (self.m, self.k), self.n = a.shape, b.shape[0]
        knw, wgs, _, _ = mb.loop_layout(self.m, self.k, self.n, mode, SMS)
        self.cols = knw * wgs
        self.tiles = math.ceil(self.m / 64)
        self.n_lead = math.ceil(self.k / self.cols)
        self.kw = self.k // 32
        self.flags = np.zeros((self.tiles, reps), np.int64)
        self.bits = np.zeros((reps, self.tiles * 64, self.k), np.int64)  # the parity, a bit a column
        self.stored = np.zeros((reps, self.tiles * 64, self.kw), bool)
        self.out = torch.zeros((self.m, self.n), dtype=torch.int32 if mode == "i8" else torch.float32)
        self.a0 = torch.zeros((self.tiles * 64, self.k), dtype=a.dtype)
        self.a0[: self.m] = a


def block(card: Card, x: int, y: int, skip_wait: bool = False):
    """One block's steps as a generator; it yields where the kernel's block
    may be overtaken by others, and ``SPIN`` while it waits on a flag."""
    rows = slice(64 * y, 64 * y + 64)
    col0 = x * card.cols
    lead = col0 < card.k
    lw0, lw1 = col0 // 32, min(card.k, col0 + card.cols) // 32  # a lead block's words
    mine = np.zeros(card.kw, bool)
    if lead:
        mine[lw0:lw1] = True
    bufs = [np.zeros((64, card.k), np.int64), np.zeros((64, card.k), np.int64)]
    reader = [0, None]  # the step that reads each shared buffer next (None: read already)
    bt = card.b[col0 : col0 + card.cols].double().T
    acc = torch.zeros((64, card.cols), dtype=card.out.dtype)

    def fill(s: int, cols, values) -> None:
        nxt = (s + 1) & 1
        assert reader[nxt] in (None, s + 1), f"block {x},{y} refilled a buffer step {reader[nxt]} still needs"
        bufs[nxt][:, cols] = values
        reader[nxt] = s + 1

    def copy(s: int, words):
        assert card.stored[s, rows][:, words].all(), f"block {x},{y} read bits[{s}] before every lead stored them"
        cols = np.repeat(words, 32)
        fill(s, cols, card.bits[s, rows][:, cols])
        yield

    for s in range(card.reps):
        cur = s & 1
        more = s + 1 < card.reps
        assert reader[cur] == s, f"block {x},{y} step {s} found no bits"
        x_a = card.a0[rows] + torch.from_numpy(bufs[cur]).to(card.a.dtype)  # in a's arithmetic
        reader[cur] = None
        # warp 0's handshake under the build
        if lead and card.n_lead == 1 and s > 0:
            card.flags[y, s - 1] += 1
        if not lead and more:
            while card.flags[y, s] < card.n_lead and not skip_wait:
                yield SPIN
        yield  # the product is issued
        d = x_a.double() @ bt
        if not lead and more:
            yield from copy(s, np.ones(card.kw, bool))
        yield  # the product is done
        acc = acc + d.to(acc.dtype)
        if lead and more:
            cols = slice(col0, min(card.k, col0 + card.cols))
            par = (acc[:, : cols.stop - col0] % 2).numpy().astype(np.int64)
            assert not card.stored[s, rows, lw0:lw1].any(), f"bits[{s}] stored twice"
            card.bits[s, rows, cols] = par
            card.stored[s, rows, lw0:lw1] = True
            fill(s, cols, par)
            if card.n_lead > 1:
                card.flags[y, s] += 1
                yield
                while card.flags[y, s] < card.n_lead and not skip_wait:
                    yield SPIN
                yield from copy(s, ~mine)
        yield  # the step's last barrier
    live = min(64, card.m - 64 * y)
    card.out[64 * y : 64 * y + live, col0 : col0 + card.cols] = acc[:live]


def run_card(a, b, mode: str, reps: int, seed: int, skip_wait: bool = False) -> torch.Tensor:
    """Every block to its end in a random interleaving; fails on a
    deadlock."""
    card = Card(a, b, mode, reps)
    progs = {(x, y): block(card, x, y, skip_wait) for x in range(card.n // card.cols) for y in range(card.tiles)}
    spinning = dict.fromkeys(progs, False)  # spun since the last step any block took
    rng = np.random.default_rng(seed)
    while progs:
        live = list(progs)
        assert not all(spinning[key] for key in live), "every block waits: deadlock"
        key = live[rng.integers(len(live))]
        try:
            spun = next(progs[key]) == SPIN
        except StopIteration:
            del progs[key]
            spun = False
        if spun:
            spinning[key] = True
        else:
            spinning = dict.fromkeys(progs, False)
    return card.out


def operands(m: int, k: int, n: int, mode: str, seed: int):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 127, (m, k)).astype(np.int8))  # a + 1 stays an i8
    b = torch.from_numpy(rng.integers(-127, 127, (n, k)).astype(np.int8))
    return (a.bfloat16(), b.bfloat16()) if mode == "bf16" else (a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", HANDSHAKE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_handshake_under_interleavings(shape, mode):
    m, k, n, reps = shape
    a, b = operands(m, k, n, mode, m + k + n)
    want = mb.loop_matmul_plain(a, b, mode, reps)
    for seed in range(ORDERS):
        got = run_card(a, b, mode, reps, seed)
        assert got.dtype == want.dtype and torch.equal(got, want), f"interleaving {seed}"


def test_the_model_catches_a_missing_wait():
    """A block that reads bits[s] without waiting for flag s fails the
    model's assert under some interleaving."""
    a, b = operands(64, 128, 512, "i8", 3)
    with pytest.raises(AssertionError, match="before every lead stored them"):
        for seed in range(20):
            run_card(a, b, "i8", 4, seed, skip_wait=True)


def test_layouts_fit_the_card():
    """Every handshake shape has a block layout of at most one block an SM,
    and the script's shape takes 128 blocks of 64 x 256 with one lead block
    a row tile."""
    for m, k, n, _ in HANDSHAKE_SHAPES + PAD_SHAPES:
        for mode in MODES:
            knw, wgs, slots, _ = mb.loop_layout(m, k, n, mode, SMS)
            assert n % (knw * wgs) == 0 and math.ceil(m / 64) * n // (knw * wgs) <= SMS and slots >= 1
    assert mb.loop_layout(256, 256, 8192, "bf16", SMS) == (128, 2, 4, 1)
    with pytest.raises(ValueError):
        mb.loop_layout(256, 64, 8192 + 64, "i8", SMS)  # 516 blocks of 64 columns


def lift(script: str, names, **consts) -> dict:
    """The named top-level functions of ``scripts/<script>``, defined in a
    namespace holding ``consts``, ``pl.pallas_call`` in interpret mode."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    shim = SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    path = SCRIPTS / script
    tree = ast.parse(path.read_text(), filename=str(path))
    body = [node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name in names]
    ns = dict(jax=jax, jnp=jnp, np=np, pl=shim, functools=functools, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", PAD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_padded_shapes_match_pallas(shape, mode):
    m, k, n, reps = shape
    ns = lift("tpu_i8_matmul_probe.py", ("dot", "pallas_loop"), M=m, K=k, N=n, REPS=reps)
    import jax.numpy as jnp

    a, b = operands(m, k, n, mode, m + reps)
    ja, jb = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if mode == "bf16" else jnp.asarray(t.numpy())
              for t in (a, b))
    want = np.asarray(ns["pallas_loop"](mode)(ja, jb))
    got = mb.loop_matmul(a, b, mode, reps).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (m, n)
    np.testing.assert_array_equal(got, want)
    if reps == 512:
        assert np.abs(want).max() > 2**24
    np.testing.assert_array_equal(run_card(a, b, mode, min(reps, 12), 0).numpy(),
                                  mb.loop_matmul_plain(a, b, mode, min(reps, 12)).numpy())


def test_loop_breakdown_stamps_the_step_loop():
    """Each stamp of `loop_breakdown` replaces one line of
    csrc/matmul_probe.cu, inside `loop_wgmma`'s step loop (or the header
    and the C entry points), so a change of the kernel cannot leave the
    breakdown timing other code."""
    src = (Path(mb.__file__).resolve().parents[1] / "csrc" / "matmul_probe.cu").read_text()
    loop = src[src.index("  for (int s = 0; s < p.reps; ++s) {"):src.index("  // acc out: rows 16 warp")]
    for old, _ in loop_breakdown.STAMPS:
        assert src.count(old) == 1, old
        assert old in loop or old in ('#include "wgmma_common.cuh"\n', 'extern "C" {\n'), old
    text = loop_breakdown._variant_source(loop_breakdown.STAMPS, "matmul_probe.cu")
    assert text.count("STAMP(") == 9 and "usearch_loop_trace" in text
