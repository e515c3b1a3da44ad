"""Kernel B7's selection as the tensor-core kernel makes it (csrc/probe.cu
`grouped_wgmma`, flavour kB7Keys), in a numpy model kept here, against B7's
plain version `binned_probe_plain` for every admitted (bw, keep, pack or
fminarg).

The model follows the kernel's registers. After `wgmma` m64n128 a thread of
a quad (l % 4 = q, c2 = 2 q) holds, of each of its lanes, the 32 rows 8 j +
c2 + e of a 128-row tile (j < 16, e < 2), as r = 2 j + e. A bw-row sub-bin
is `rows` = max(bw / 4, 2) of a thread's rows, an aligned run of r, and
`sharing` = bw / rows threads of the quad hold it (bw 2: one, bw 4: two, bw
8 and up: four). Round t: each thread's best (key, row) of each of its runs
by a tree (row pairs, then runs of 4, 8, ... rows), the best of the sharing
threads by xor shuffles (1, then 2), written by the thread whose q matches
t in the low bits, then removed by the thread holding it. The key is -dot
(``pack``) or -dot rounded to f32 (``fminarg``), the lower row first on
equal keys. Planted equal dots fall inside a thread's rows and across the
quad's; at 2,048-byte rows the dots pass 2**24, where f32 ties neighbours
that ``pack`` orders. Everything is integer, so the comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from usearch_torch.ops import probe  # noqa: E402

INT_MAX = np.iinfo(np.int32).max
#: every (sel, bw, keep) `binned_probe` admits
SELECTIONS = [(sel, bw, keep) for sel in probe.BIN_SELECTIONS for bw in (2, 4, 8, 16, 32, 64, 128)
              if sel == "fminarg" or bw <= 32 for keep in range(1, min(probe.MAX_KEEP, bw // 2) + 1)]
#: the quad's rows of a tile: [thread q, r] -> column 8 (r // 2) + 2 q + r % 2
COLS = 8 * (np.arange(32) // 2)[None, :] + 2 * np.arange(4)[:, None] + (np.arange(32) % 2)[None, :]


def quad_select(dots: np.ndarray, bw: int, keep: int, sel: str):
    """The kernel's rounds over ``dots [L, w_pad]`` (exact int64, one row
    per lane, the padded window's rows): ``([L, keep * w_pad / bw]`` f32
    keys, rows inside the window), round-major."""
    n_lanes, w_pad = dots.shape
    nbw = w_pad // bw
    key = -dots
    if sel == "fminarg":
        key = key.astype(np.float32).astype(np.int64)
    rows = max(bw // 4, 2)
    sharing = bw // rows
    out_k = np.zeros((n_lanes, keep * nbw), np.int64)
    out_r = np.full((n_lanes, keep * nbw), -1, np.int64)
    for tile in range(w_pad // 128):
        held = key[:, tile * 128 : (tile + 1) * 128][:, COLS]  # [L, 4, 32]
        for t in range(keep):
            lo, hi = held[..., 0::2], held[..., 1::2]
            bk = np.where(hi < lo, hi, lo)
            bc = COLS[None, :, 0::2] + (hi < lo)
            s = 1
            while s < 16:
                if rows >= 4 * s:
                    for i in range(0, 16, 2 * s):
                        take = bk[..., i + s] < bk[..., i]
                        bk[..., i] = np.where(take, bk[..., i + s], bk[..., i])
                        bc[..., i] = np.where(take, bc[..., i + s], bc[..., i])
                s *= 2
            for i in range(0, 16, rows // 2):
                for m in (1, 2):
                    if m >= sharing:
                        break
                    other = [q ^ m for q in range(4)]
                    ok, oc = bk[:, other, i], bc[:, other, i]
                    take = (ok < bk[..., i]) | ((ok == bk[..., i]) & (oc < bc[..., i]))
                    bk[..., i] = np.where(take, ok, bk[..., i])
                    bc[..., i] = np.where(take, oc, bc[..., i])
                for q in range(4):
                    if (q & (sharing - 1)) == (t & (sharing - 1)):
                        col = t * nbw + tile * (128 // bw) + (8 * i + 2 * q) // bw
                        out_k[:, col] = bk[:, q, i]
                        out_r[:, col] = tile * 128 + bc[:, q, i]
            s = 8
            while s >= 1:
                if rows >= 4 * s:
                    for i in range(0, 16, 2 * s):
                        bc[..., i + s] = bc[..., i]
                s //= 2
            held = np.where(COLS[None] == bc[..., np.arange(32) // 2], INT_MAX, held)
    return out_k.astype(np.float32), out_r


def planted(w: int, rng):
    """(queries [40, w], table [512, w], padded-window bases of 256 rows):
    values in -2..2 with rows 1, 3, 64, 130 copies of row 0 (ties inside a
    thread, across the quad, across tiles); at w = 2,048 rows of 127 but the
    last column and queries 127 but a last 1, dots above 2**24 that differ
    by the last column alone."""
    n, nq = 512, 40
    if w < 2048:
        table = rng.integers(-2, 3, (n, w)).astype(np.int8)
        table[[1, 3, 64, 130]] = table[0]
        q = table[rng.integers(0, n, nq)]
    else:
        table = np.full((n, w), 127, np.int8)
        table[:, -1] = rng.integers(-127, 128, n)
        table[5] = table[4]
        q = np.full((nq, w), 127, np.int8)
        q[:, -1] = 1
    base = (rng.integers(0, (n - 256) // 128 + 1, nq) * 128).astype(np.int32)
    return q, table, base


@pytest.mark.parametrize("sel,bw,keep", SELECTIONS)
def test_quad_selection_matches_plain(sel, bw, keep):
    rng = np.random.default_rng(bw * 16 + keep + (sel == "pack"))
    for w in (128, 2048):
        q, table, base = planted(w, rng)
        rows = base[:, None] + np.arange(256)
        dots = np.einsum("lw,lrw->lr", q.astype(np.int64), table[rows].astype(np.int64))
        if w == 2048:
            assert dots.min() > 2**24
        keys, at = quad_select(dots, bw, keep, sel)
        nq = q.shape[0]
        pad = -nq % 128  # cells of 128 pairs: the padding pairs' windows are past the table
        q_g = torch.from_numpy(np.concatenate([q, np.zeros((pad, w), np.int8)]))
        win_base = torch.from_numpy(np.concatenate([base, np.full(pad, table.shape[0], np.int32)]))
        d, i = probe.binned_probe(q_g, torch.from_numpy(table), win_base, 256, bw, keep, sel)
        used = keep * 256 // bw
        np.testing.assert_array_equal(d[:nq, :used].numpy(), keys)
        np.testing.assert_array_equal(i[:nq, :used].numpy(), base[:, None] + at)
        assert (i[:nq, used:] == -1).all() and (i[nq:] == -1).all()


def test_fminarg_ties_what_pack_orders():
    """Above 2**24, dots one apart round to one f32 key: ``fminarg`` takes
    the lower row of the two where ``pack`` takes the larger dot."""
    dots = np.zeros((1, 128), np.int64)
    dots[0, 0], dots[0, 1] = 2**25 + 4, 2**25 + 5  # -dot in f32: -(2**25 + 4) both
    keys_p, rows_p = quad_select(dots, 2, 1, "pack")
    keys_f, rows_f = quad_select(dots, 2, 1, "fminarg")
    assert rows_p[0, 0] == 1 and rows_f[0, 0] == 0 and keys_p[0, 0] == keys_f[0, 0] == np.float32(-(2**25 + 4))
