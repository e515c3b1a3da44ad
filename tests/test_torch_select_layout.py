"""Kernel B12 as the redesigned kernel computes it (csrc/select.cu
`select_kernel`), in a numpy model kept here, against B12's plain version
(`ops/microbench.select_loop_plain`) and the TPU script's Pallas kernel in
interpret mode, for every variant.

The model follows the kernel's threads. The grid is G/32 column groups x P
pass groups (P = max(1, SMs / (G/32)); 1 and 8 for astype_only and
pack_only, which read a few rows a pass); block (c, p) stages its 32 columns
and its two slots (two warps each) run passes i with i % P == p, slot (i /
P) % 2. A warp owns a 16-column slab; lane l takes columns l/4 and l/4 + 8
of it and of each 128-row tile the rows 8 j + c2 + e (j < 16, e < 2, c2 =
2 (l % 4)): the M and N sides of a `wgmma` accumulator fragment. A thread
reduces its own values of a group in ascending rows (8 a column for a 32-row
group, 32 for a 128-row one), then two xor shuffles (1, then 2) finish the
group across the quad, the packed key's minimum or the (value, row) pair in
lexicographic order; each group's result joins a per-column running sum in
group order (i32 wrapping, f32 rounded at each addition). astype_only
gathers rows 0-7 of the quad and adds them in order; pack_only sums the
packed keys of rows 32 b + c2 into four partial sums, whose c2 = 0 thread
holds the answer. Only the slot running pass IT - 1 stores row 0.

Inputs: random values, columns that wrap at x + i, entries that reach
INT32_MIN in the last pass (the packed key's negation of it wraps to
itself), values above 2**24 that f32 ties, and a group's minimum planted at
rows inside a thread (e, j) and across the quad's threads. Tolerances: the
model against the plain version bit for bit (both add in group order);
against Pallas bit for bit, except the f32 sums of group minima of
f32_min32 and f32_minarg32, which XLA adds in another order: 1e-6
relative, as tests/test_torch_microbench.py and chip_smoke.py hold them
(3.3e-7 apart at most here, with minima near -2**31)."""

import ast
import functools
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from usearch_torch.build import _CSRC  # noqa: E402
from usearch_torch.microbench import select_breakdown  # noqa: E402
from usearch_torch.ops import microbench as mb  # noqa: E402

VARIANTS = list(mb.SELECT_VARIANTS)
#: SELECT_CHECK's small shapes (chip_smoke.py): (W, G, IT)
SHAPES = [(256, 64, 5), (1536, 32, 3)]
#: an H100's SMs, and the kernel's constants
SMS, COLS, SLOTS, PITCH = 132, 32, 2, 36
#: the quad's rows of a 128-row tile: [q, j, e] -> 8 j + 2 q + e
ROWS = 8 * np.arange(16)[None, :, None] + 2 * np.arange(4)[:, None, None] + np.arange(2)[None, None, :]
#: the f32 sums of group minima that XLA adds in another order, and how far
#: apart they may lie (chip_smoke.py's SELECT_RTOL)
F32_SUMS, SUM_RTOL = ("f32_min32", "f32_minarg32"), 1e-6
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def wrap32(v):
    return ((np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int64)


def packed_key(v, row):
    """((-v) << 5) | row in wrapping 32-bit arithmetic, as int64."""
    return wrap32((((-np.asarray(v, np.int64)) % 2**32) << 5) % 2**32 | row)


def group_size(variant: str) -> int:
    return 128 if variant.endswith("128") else 32


#: the pass groups of the variants that read a few rows a pass
FEW_ROWS = {"astype_only": 1, "pack_only": 8}


def pass_groups(g: int, variant: str, sms: int = SMS) -> int:
    """P of csrc/select.cu `pass_groups`."""
    return FEW_ROWS.get(variant, max(1, sms // (g // COLS)))


def slot_passes(p: int, slot: int, n_groups: int, iters: int) -> range:
    """The passes slot ``slot`` of pass group ``p`` runs, in its order."""
    return range(p + n_groups * slot, iters, n_groups * SLOTS)


def quad_rounds(pairs, lexicographic: bool):
    """The two xor shuffles over axis 0 (the thread q of the quad): min of
    values, or of (value, row) pairs in lexicographic order."""
    for s in (1, 2):
        partner = [q ^ s for q in range(4)]
        if lexicographic:
            m, a = pairs
            om, oa = m[partner], a[partner]
            take = (om < m) | ((om == m) & (oa < a))
            pairs = (np.where(take, om, m), np.where(take, oa, a))
        else:
            pairs = np.minimum(pairs, pairs[partner])
    return pairs


def thread_values(xi: np.ndarray) -> np.ndarray:
    """What each quad thread holds: ``[T tiles, 4 (q), 16 (j), 2 (e), G]``
    of x + i (int64, wrapped), the rows of `ROWS` in each tile."""
    t = np.arange(xi.shape[0] // 128)[:, None, None, None] * 128
    return xi[t + ROWS[None]]


def model_pass(xi: np.ndarray, variant: str) -> np.ndarray:
    """One pass, thread by thread: the ``[G]`` f32 row 0 (x + i given)."""
    w, g = xi.shape
    if variant == "astype_only":
        held = xi[ROWS[:, 0, :]].astype(np.float32)  # [4 (q), 2 (e), G]: rows 2 q + e of tile 0
        s = held[0, 0]
        for r in range(1, 8):  # each thread gathers the quad's eight in order
            s = np.float32(s + held[r // 2, r % 2])
        return s
    if variant == "pack_only":
        parts = np.zeros((4, 4, g), np.int64)  # [q, partial sum k, G]
        for r in range(0, w, 32):  # row r + c2: its row term is c2
            for q in range(4):
                parts[q, r // 32 % 4] = wrap32(parts[q, r // 32 % 4] + packed_key(xi[r + 2 * q], 2 * q))
        return wrap32(parts[0].sum(axis=0)).astype(np.float32)  # the c2 = 0 thread's
    held = thread_values(xi)
    gs = group_size(variant)
    kj = gs // 8
    isum, fsum = np.zeros(g, np.int64), np.full(g, -0.0, np.float32)
    for tile in held:  # [4, 16, 2, G]
        for b in range(128 // gs):
            part = tile[:, b * kj : (b + 1) * kj].reshape(4, 2 * kj, g)  # ascending rows (j, e)
            rows = (8 * (np.arange(2 * kj) // 2)[None, :] + 2 * np.arange(4)[:, None] + np.arange(2 * kj)[None, :] % 2)
            if variant in ("i32_min128", "i32_min32", "pack_min32"):
                keys = packed_key(part, rows[..., None]) if variant == "pack_min32" else part
                m = quad_rounds(keys.min(axis=1), lexicographic=False)
                assert (m == m[0]).all()
                isum = wrap32(isum + m[0])
            elif variant == "f32_min32":
                m = quad_rounds(part.astype(np.float32).min(axis=1), lexicographic=False)
                fsum = np.float32(fsum + m[0])
            else:
                v = part.astype(np.float32)
                m, a = v[:, 0].copy(), np.broadcast_to(rows[:, :1], v[:, 0].shape).copy()
                for r in range(1, 2 * kj):  # strict '<': the thread's first minimum
                    take = v[:, r] < m
                    m, a = np.where(take, v[:, r], m), np.where(take, rows[:, r : r + 1], a)
                m, a = quad_rounds((m, a), lexicographic=True)
                assert (m == m[0]).all() and (a == a[0]).all()
                fsum, isum = np.float32(fsum + m[0]), wrap32(isum + a[0])
    if variant == "f32_min32":
        return fsum
    if variant.startswith("f32_minarg"):
        return np.float32(fsum + isum.astype(np.float32))
    return isum.astype(np.float32)


def model_select_loop(x: np.ndarray, variant: str, iters: int, sms: int = SMS) -> np.ndarray:
    """The whole launch: every block's slots run their passes; only the
    slot running pass ``iters - 1`` stores row 0. Checks that every pass
    runs once and every column is stored once."""
    w, g = x.shape
    n_groups = pass_groups(g, variant, sms)
    out = np.zeros((8, g), np.float32)
    ran, stores = np.zeros(iters, int), np.zeros(g, int)
    for c in range(g // COLS):
        cols = slice(c * COLS, (c + 1) * COLS)
        for p in range(n_groups):
            for slot in range(SLOTS):
                for i in slot_passes(p, slot, n_groups, iters):
                    ran[i] += c == 0
                    v = model_pass(wrap32(x[:, cols].astype(np.int64) + i), variant)
                    if i == iters - 1:
                        out[0, cols] = v
                        stores[cols] += 1
    assert (ran == 1).all() and (stores == 1).all()
    return out


#: rows of a 32-row group holding column 5's minimum, and column 9's f32 ties
TIES_INT, TIES_F32 = (1, 2, 8, 17, 30), (4, 6, 7, 22)


def case(w: int, g: int, iters: int, seed: int) -> np.ndarray:
    """Random values; column 1 wraps at x + i; entries of the other columns
    reach INT32_MIN in the last pass; column 3 lies above 2**24, where f32
    ties rows the ints order; in column 5 every 32-row group's minimum sits
    at rows 1, 2, 8, 17 and 30 (inside a thread: e and j; across the quad);
    in column 9 rows 4, 6, 7 and 22 of a group tie in f32 and not as ints."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2_000_000, 2_000_000, (w, g)).astype(np.int64)
    planted = rng.random((w, g)) < 0.02
    planted[:, [1, 3, 5, 9]] = False
    x[planted] = INT32_MIN - (iters - 1)
    x[:, 1] = INT32_MAX - rng.integers(0, iters, w)
    x[:, 3] = 2**25 + rng.integers(0, 8, w)
    for r in range(0, w, 32):
        x[r + np.array(TIES_INT), 5] = x[r : r + 32, 5].min() - 7
        x[r + np.array(TIES_F32), 9] = -(2**26) - np.array([1, 3, 4, 2]) - (iters - 1)
    return wrap32(x).astype(np.int32)


def interpreted_pallas():
    shim = SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return shim


def pallas_select(x: np.ndarray, variant: str, iters: int) -> np.ndarray:
    """Row 0 of the TPU script's kernel, lifted from its source (it runs its
    benchmark when imported), in interpret mode."""
    path = Path(__file__).resolve().parent.parent / "scripts" / "tpu_select_microbench.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    body = [node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == "make"]
    w, g = x.shape
    ns = dict(jax=jax, jnp=jnp, pl=interpreted_pallas(), W=w, G=g, IT=iters)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    call = pl.pallas_call(ns["make"](variant), out_shape=jax.ShapeDtypeStruct((8, g), jnp.float32),
                          in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                          out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return np.asarray(call(jnp.asarray(x)))[0]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", VARIANTS)
def test_layout_model_matches_plain_and_pallas(variant, shape):
    w, g, iters = shape
    x = case(w, g, iters, seed=w + g + VARIANTS.index(variant))
    got = model_select_loop(x, variant, iters)
    want = mb.select_loop_plain(torch.from_numpy(x), variant, iters).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1:].any()
    tpu = pallas_select(x, variant, iters)
    if variant in F32_SUMS:
        np.testing.assert_allclose(got[0], tpu, rtol=SUM_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got[0], tpu)


def test_case_plants_what_it_says():
    """Column 5's group minimum at rows 1, 2, 8, 17 and 30, the first row 1;
    column 9's f32 minimum at rows 4, 6, 7 and 22 (thread 2 first, then
    thread 3's rows), the first row 4, where the ints' minimum is row 7;
    column 1 wraps; INT32_MIN is reached in the last pass."""
    w, g, iters = SHAPES[0]
    last = wrap32(case(w, g, iters, seed=3).astype(np.int64) + iters - 1)
    for r in range(0, w, 32):
        grp = last[r : r + 32]
        assert list(np.flatnonzero(grp[:, 5] == grp[:, 5].min())) == list(TIES_INT)
        f = grp[:, 9].astype(np.float32)
        assert list(np.flatnonzero(f == f.min())) == list(TIES_F32) and f.argmin() == 4 and grp[:, 9].argmin() == 7
    assert (last[:, 1] < 0).any() and (last[:, 1] > 0).any()
    assert (last == INT32_MIN).any()


@pytest.mark.parametrize("variant", ["i32_min32", "astype_only"])
@pytest.mark.parametrize("g", [32, 64, 128, 4224, 8448])
@pytest.mark.parametrize("iters", [1, 5, 200])
def test_every_pass_runs_once(g, iters, variant):
    n_groups = pass_groups(g, variant)
    slots = [(p, s) for p in range(n_groups) for s in range(SLOTS)]
    runs = np.concatenate([list(slot_passes(p, s, n_groups, iters)) for p, s in slots])
    assert n_groups >= 1 and np.array_equal(np.sort(runs), np.arange(iters))


@pytest.mark.parametrize("variant", VARIANTS)
def test_rounds_grow_linearly_at_the_scripts_shape(variant):
    """The busiest slot's rounds at the script's IT and 2 IT: the time a
    pass (rounds beyond the 1-pass launch's, over the passes beyond one)
    agrees within chip_smoke's PASS_STEADY of 10% (asserted tighter here,
    2%)."""
    n_groups = pass_groups(128, variant)
    slots = [(p, s) for p in range(n_groups) for s in range(SLOTS)]
    rounds = {it: max(len(slot_passes(p, s, n_groups, it)) for p, s in slots) for it in (1, 200, 400)}
    assert rounds == {1: 1, 200: math.ceil(200 / (SLOTS * n_groups)), 400: math.ceil(400 / (SLOTS * n_groups))}
    per, per2 = (rounds[200] - rounds[1]) / 199, (rounds[400] - rounds[1]) / 399
    assert abs(per2 - per) / per < 0.02


@pytest.mark.parametrize("variant", VARIANTS)
def test_blocks_at_the_scripts_shape(variant):
    """Every SM for the reducing variants; 4 and 32 blocks (100 and 13
    rounds) for the two that read a few rows a pass."""
    assert 128 // COLS * pass_groups(128, variant) == {"astype_only": 4, "pack_only": 32}.get(variant, SMS)


def test_fragment_reads_and_copies_meet_on_no_bank():
    """Rows padded to 36 words: a warp's read of one (j, e, h) touches 32
    banks, and a quarter warp's 16-byte copies of one row 32 banks."""
    lane = np.arange(32)
    for slab in range(2):
        for j in range(16):
            for e in range(2):
                for h in range(2):
                    row = 8 * j + 2 * (lane % 4) + e
                    col = 16 * slab + lane // 4 + 8 * h
                    assert len(set((row * PITCH + col) % 32)) == 32
    for r in range(8):
        words = r * PITCH + 4 * np.arange(8)[:, None] + np.arange(4)[None, :]
        assert len(set(words.ravel() % 32)) == 32


@pytest.mark.parametrize("part", [p for p in select_breakdown.PARTS if p != "full"])
def test_breakdown_parts_replace_lines_of_the_source(part):
    """Each part of `select_breakdown` replaces lines csrc/select.cu still
    has, so a change of the kernel cannot leave it timing the full one."""
    source = (_CSRC / "select.cu").read_text()
    for old, _ in select_breakdown.PARTS[part]:
        assert old in source, f"select_breakdown part {part} replaces a line select.cu no longer has"


def test_model_constants_are_the_kernels():
    source = (_CSRC / "select.cu").read_text()
    for name in (f"kSlots = {SLOTS};", f"kPitch = {PITCH};", f"kCols = {COLS};", "*groups = fill > 1 ? fill : 1;",
                 "*groups = variant == kAstypeOnly ? 1 : 8;"):
        assert name in source


def test_select_blocks_refuses():
    for g, variant in ((0, "i32_min32"), (48, "i32_min32"), (128, "min")):
        with pytest.raises(ValueError):
            mb.select_blocks(g, variant, "cpu")


def test_breakdown_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert select_breakdown.main([]) == 1
