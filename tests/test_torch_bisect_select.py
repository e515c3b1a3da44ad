"""Kernel B13's selects as the tensor-core kernel makes them (csrc/bisect.cu
`bisect_wgmma`), in a numpy model kept here, against the select of B13's
plain version (`ops/microbench._bisect_select`) and against
`bisect_probe_plain` for every variant.

The model follows the kernel's registers. After `wgmma` m64n128 a thread of
a quad (q = l % 4, c2 = 2 q) holds, of each of its two lanes, the 32 rows
8 j + c2 + e of a 128-row tile (j < 16, e < 2); the quad holds a lane's 128
rows. sel8: one j is an 8-row bin, two rows a thread, then the quad's
minimum by xor shuffles (1, then 2). sel32 and sel32f: four consecutive j
are a 32-row bin, 8 rows a thread in ascending order, then the quad (the
packed key's minimum; the f32 minimum and its first arg-minimum, ties to
the lower row). sel_none: the c2 = 0 thread's row 32 b. dot_only: rows 0-7
of a window's first tile, two f32 sums a lane and thread, window by window.
A window of w_pad = 64 mod 128 rows ends in a half tile whose rows past the
window the kernel reads and leaves out (here: rows of noise). The cell walk
skips windows outside the table and writes a lane's entries in its own
window only (none for an own window at or past n_win). Planted equal dots
fall inside a thread's rows and across the quad; at 2,048-byte rows the
dots pass 2**24, where f32 ties rows that the packed key orders. Every
comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from usearch_torch.ops import microbench as mb  # noqa: E402
from usearch_torch.ops.distances import MASKED  # noqa: E402

G = 128
#: the quad's rows of a tile: [thread q, j, e] -> row 8 j + 2 q + e
ROWS = 8 * np.arange(16)[None, :, None] + 2 * np.arange(4)[:, None, None] + np.arange(2)[None, None, :]
VARIANTS = list(mb.BISECT_VARIANTS)
SELECTS = [v for v in VARIANTS if v != "dot_only"]


def quad_reduce(x, pick):
    """The quad's xor shuffles, 1 then 2, over axis 0 (the thread q)."""
    for m in (1, 2):
        x = pick(x, x[[q ^ m for q in range(4)]])
    return x


def key32(dots):
    """((-dot) << 5) | row_in_bin in wrapping uint32 arithmetic, as int32."""
    rows = (ROWS[:, :, :] % 32).astype(np.int64)
    rows = np.broadcast_to(rows[..., None], dots.shape)
    return ((((-dots) & 0xFFFFFFFF) << 5 & 0xFFFFFFFF) | rows).astype(np.uint32).view(np.int32).astype(np.int64)


def tile_select(tile: np.ndarray, variant: str, rows: int) -> np.ndarray:
    """The kernel's select over one tile's dots ``[128 rows, L]`` (int64; rows
    past ``rows`` hold noise): ``[entries, L]`` f32, the tile's bins."""
    held = tile[ROWS]  # [4, 16, 2, L]: what each thread of a quad holds
    if variant == "sel_none":
        return held[0, 0:16:4, 0][: rows // 32].astype(np.float32)
    if variant == "sel8":
        m = quad_reduce(held.min(axis=2), np.minimum)  # [4, 16, L]
        assert (m == m[0]).all()
        return m[0, : rows // 8].astype(np.float32)
    out = []
    for bb in range(rows // 32):
        part = held[:, 4 * bb : 4 * bb + 4]  # [4, 4 (j), 2 (e), L]
        if variant == "sel32":
            k = key32(held)[:, 4 * bb : 4 * bb + 4].reshape(4, 8, -1)
            m = quad_reduce(k.min(axis=1), np.minimum)
            out.append(m[0].astype(np.float32))
            continue
        # sel32f: each thread's first minimum over its rows in ascending
        # order, then the quad's (value, row) in lexicographic order
        v = part.reshape(4, 8, -1).astype(np.float32)
        r = (ROWS[:, 4 * bb : 4 * bb + 4] % 32).reshape(4, 8)
        best, arg = v[:, 0].copy(), np.broadcast_to(r[:, :1], v[:, 0].shape).copy()
        for i in range(1, 8):
            take = v[:, i] < best
            best = np.where(take, v[:, i], best)
            arg = np.where(take, r[:, i : i + 1], arg)
        for m in (1, 2):
            ob, oa = best[[q ^ m for q in range(4)]], arg[[q ^ m for q in range(4)]]
            take = (ob < best) | ((ob == best) & (oa < arg))
            best, arg = np.where(take, ob, best), np.where(take, oa, arg)
        assert (best == best[0]).all() and (arg == arg[0]).all()
        out.append((best[0] + arg[0].astype(np.float32)).astype(np.float32))
    return np.stack(out)


def window_select(dots: np.ndarray, variant: str, rng) -> np.ndarray:
    """One window's ``[w_pad, L]`` dots tile by tile, the half last tile's
    missing rows filled with noise: the window's ``[nb, L]`` entries."""
    w_pad, n_lanes = dots.shape
    parts = []
    for t0 in range(0, w_pad, 128):
        rows = min(128, w_pad - t0)
        tile = rng.integers(-(2**40), 2**40, (128, n_lanes))
        tile[:rows] = dots[t0 : t0 + rows]
        parts.append(tile_select(tile, variant, rows))
    return np.concatenate(parts)


def model_bisect(meta, q, qa, table, variant, w_pad, out_pad, init, rng):
    """The kernel's cell walk in numpy: the ``[cells * 128, out_pad]`` f32
    output."""
    cells, n_rows = meta.shape[0], table.shape[0]
    out = np.full((cells * G, out_pad), init, np.float32)
    for c in range(cells):
        n_win = int(meta[c, 3, 0])
        sums = np.full((8, G), init, np.float32)  # dot_only: rows 0-7, lanes
        own = qa[c * G : (c + 1) * G, 2]
        for w in range(max(n_win, 0)):
            st = int(meta[c, 0, min(w, G - 1)])
            if st < 0 or st > n_rows - w_pad:
                continue  # outside the table
            # exact: the dots are integers far below 2**53
            dots = (table[st : st + w_pad].astype(np.float64) @ q[c * G : (c + 1) * G].astype(np.float64).T).astype(
                np.int64)
            if variant == "dot_only":
                sums = (sums + dots[:8].astype(np.float32)).astype(np.float32)  # one rounding a window
                continue
            v = window_select(dots, variant, rng)  # every lane's select, in every window
            mine = own == np.float32(w)
            out[c * G : (c + 1) * G][mine, : v.shape[0]] = v.T[mine]
        if variant == "dot_only":
            out[c * G : (c + 1) * G, :8] = sums.T
    return out


def dots_case(kind: str, w_pad: int, rng):
    """``[n_win, w_pad, 128]`` dots: random, with planted equal dots (inside a
    thread's rows: rows 8 j + c2 and + 1, 8 j + c2 and 8 (j + 1) + c2;
    across the quad: c2 = 0 and 2), or above 2**24 a step apart (f32 ties
    them where the packed key orders them)."""
    n_win = 3
    if kind == "big":
        base = 2**25 + rng.integers(0, 8, (n_win, w_pad, G))
        return base * rng.choice([-1, 1], (n_win, 1, G))
    dots = rng.integers(-(2**21), 2**21, (n_win, w_pad, G))
    if kind == "ties":
        for r in range(0, w_pad, 32):
            dots[:, r + 1] = dots[:, r]  # inside a thread (e)
            dots[:, r + 2] = dots[:, r]  # across the quad
            dots[:, r + 8] = dots[:, r]  # inside a thread (j)
            low = dots[:, r : r + 32].min(axis=1)
            dots[:, r + 3] = low  # the bin's minimum reached twice
            dots[:, r + 17] = low
    return dots


@pytest.mark.parametrize("kind", ["random", "ties", "big"])
@pytest.mark.parametrize("w_pad", [1408, 1344])
@pytest.mark.parametrize("variant", SELECTS)
def test_quad_select_matches_bisect_select(variant, w_pad, kind):
    rng = np.random.default_rng(w_pad + len(kind) + SELECTS.index(variant))
    dots = dots_case(kind, w_pad, rng)
    want = mb._bisect_select(torch.from_numpy(dots), variant).numpy()  # [n_win, nb, G]
    got = np.stack([window_select(d, variant, rng) for d in dots])
    assert got.shape == want.shape == (dots.shape[0], mb.bisect_bins(variant, w_pad), G)
    np.testing.assert_array_equal(got, want)


def cell_case(w_pad: int, width: int, rng, planted: bool):
    """Two cells of 128 lanes over a table of 12 windows' rows: cell 0 with
    windows past the table's end and at a negative start, lanes whose own
    window is at or past n_win; cell 1 with more than 127 windows (those
    from 127 on share meta[c, 0, 127]). Planted: rows of a window that copy
    its row 0 inside a thread and across the quad."""
    n_rows = 12 * w_pad + 64
    if width >= 2048:
        table = np.full((n_rows, width), 127, np.int8)
        table[:, -1] = rng.integers(-127, 128, n_rows)
        q = np.full((2 * G, width), 127, np.int8)
        q[:, -1] = rng.integers(-2, 3, 2 * G)
    else:
        table = rng.integers(-127, 128, (n_rows, width)).astype(np.int8)
        q = rng.integers(-127, 128, (2 * G, width)).astype(np.int8)
    meta = np.zeros((2, 8, G), np.int32)
    starts = rng.integers(0, n_rows - w_pad + 1, G).astype(np.int32)
    meta[:, 0] = starts
    meta[0, 0, 2] = n_rows - w_pad + 1  # one row past the end
    meta[0, 0, 5] = -3
    meta[0, 3] = 9
    meta[1, 3] = 130  # windows 127-129 share meta[1, 0, 127]
    if planted:
        for st in starts[:9]:
            for off in (1, 2, 8, 34):
                table[st + off] = table[st]
    qa = np.zeros((2 * G, 8), np.float32)
    qa[:G, 2] = rng.integers(0, 9, G)
    qa[:7, 2] = [9, 40, 200, 2, 5, 0, 8]  # at or past n_win; windows skipped
    qa[G:, 2] = rng.integers(0, 130, G)
    return meta, q, qa, table


@pytest.mark.parametrize("init", [MASKED, 0.0], ids=["masked", "zero"])
@pytest.mark.parametrize("w_pad", [1408, 1344])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cell_model_matches_plain(variant, w_pad, init):
    rng = np.random.default_rng(w_pad + VARIANTS.index(variant))
    meta, q, qa, table = cell_case(w_pad, 128, rng, planted=True)
    out_pad = 256 if w_pad // 8 <= 256 else 320
    want = mb.bisect_probe_plain(*(torch.from_numpy(x) for x in (meta, q, qa, table)), variant, w_pad, out_pad,
                                 init=init).numpy()
    got = model_bisect(meta, q, qa, table, variant, w_pad, out_pad, init, rng)
    np.testing.assert_array_equal(got, want)
    if variant != "dot_only":
        # lanes without a window of their own keep init everywhere
        for lane in (0, 1, 2, 3, 4):
            assert (got[lane] == np.float32(init)).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_cell_model_matches_plain_past_2_24(variant):
    rng = np.random.default_rng(7 + VARIANTS.index(variant))
    meta, q, qa, table = cell_case(1344, 2048, rng, planted=False)
    meta[1, 3] = 4  # a short walk: the dots of 2,048-byte rows are many
    qa[G:, 2] = rng.integers(0, 4, G)
    dots = table[meta[0, 0, 0] : meta[0, 0, 0] + 8].astype(np.float64) @ q[:1].astype(np.float64).T
    assert dots.min() > 2**24
    want = mb.bisect_probe_plain(*(torch.from_numpy(x) for x in (meta, q, qa, table)), variant, 1344, 256).numpy()
    np.testing.assert_array_equal(model_bisect(meta, q, qa, table, variant, 1344, 256, MASKED, rng), want)


def test_f32_ties_what_the_packed_key_orders():
    """Above 2**24, dots one apart round to one f32: sel32f takes the lower
    row of the two (rows 3 and 6, two threads of the quad), sel32's key the
    larger dot."""
    tile = np.zeros((128, 1), np.int64)
    tile[:32] = 2**26
    tile[3], tile[6] = 2**25 + 5, 2**25 + 4  # f32: 2**25 + 4 both
    assert tile_select(tile, "sel32f", 128)[0, 0] == np.float32(2**25 + 4) + np.float32(3)
    tile[:32] = -5
    tile[3], tile[6] = 2**25 + 5, 2**25 + 4
    assert tile_select(tile, "sel32", 128)[0, 0] == np.float32(-(2**25 + 5) * 32 + 3)
