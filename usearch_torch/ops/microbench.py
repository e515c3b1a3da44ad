"""The micro-benchmark kernels B11, B12 and B13, and their plain versions.

Counterparts of the three Pallas kernels under `scripts/`, each of which
isolates one cost of the TPU kernels:

| kernel | TPU kernel (script) | here | CUDA |
|---|---|---|---|
| B11 | `pallas_loop(mode)` (tpu_i8_matmul_probe.py) | `loop_matmul` | csrc/matmul_probe.cu |
| B12 | `make(variant)` (tpu_select_microbench.py) | `select_loop` | csrc/select.cu |
| B13 | `make_kernel(variant, out_pad)` (tpu_probe_v2_bisect.py) | `bisect_probe` | csrc/bisect.cu |

B11 runs ``reps`` loop-carried products: ``acc`` ``[M, N]`` starts at 0,
and every step takes ``a = a0 + acc[:, :K] % 2`` (a floor-mod, so 0 or 1)
and adds ``a @ b0.T`` to ``acc``. The modes are those of the script:
``bf16`` (bf16 operands, f32 sums), ``i8`` (i8 operands, i32 sums),
``i8f32`` (i8 operands, f32 sums) and ``cast`` (i8 operands cast to bf16,
f32 sums). The operands hold integers, so every product of a step is an
integer and, while ``K * 128 * 128 <= 2**24``, so is every partial sum: one
step's product is exact in any order, and ``acc`` rounds (f32 modes) once
per step, in step order. The kernel and its plain version agree bit for
bit.

B12 runs ``iters`` passes over an i32 ``[W, G]`` buffer ``x``; pass ``i``
reduces ``x + i`` column by column and writes row 0 of an f32 ``[8, G]``
output, so the last pass's value stands; rows 1-7 stay 0. The variants
(`SELECT_VARIANTS`) are the script's: the f32 sum of rows 0-7
(``astype_only``); the sum of the minima of 128- or 32-row groups, in i32
(``i32_min128``, ``i32_min32``) or f32 (``f32_min32``); the i32 sum of the
packed keys ``((-x) << 5) | (row & 31)`` of every 32nd row (``pack_only``)
or of their 32-row minima (``pack_min32``); the f32 sum of the 128- or
32-row group minima plus the i32 sum of their first arg-minima
(``f32_minarg128``, ``f32_minarg32``). i32 sums wrap; f32 sums run over the
groups in order, one rounding per addition.

B13 is kernel B3's window stream cut to its select step. A cell of ``G =
128`` lanes (pairs) walks its ``meta[c, 3, 0]`` windows; window ``w``
starts at table row ``meta[c, 0, min(w, G - 1)]`` and spans ``w_pad`` rows.
Every lane dots its query with every row of every window (i32), and the
variant (`BISECT_VARIANTS`) updates the lane's ``[out_pad]`` accumulator,
which starts at ``init``: ``dot_only`` adds rows 0-7's dots to entries 0-7
in every window (no lane mask); the others keep, for the lane's own window
only (``qa[:, 2] == w``), per 32-row bin its row 0 (``sel_none``), per
8-row bin the i32 minimum (``sel8``), per 32-row bin the minimum of the
packed key ``((-dot) << 5) | row_in_bin`` (``sel32``) or the f32 minimum
plus its first arg-minimum (``sel32f``), as f32. The output is ``[cells *
G, out_pad]``. A window that does not lie inside the table is skipped (the
TPU kernel's copy would fault).

Each wrapper runs the plain version for CPU tensors and the CUDA kernel for
CUDA tensors; there is no fallback between them. Each wrapper's
``launches`` attribute counts its kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from .distances import MASKED
from .probe import _stream
from .scan import _launch, _ptr

#: B11's modes, by code of csrc/matmul_probe.cu
LOOP_MODES = {"bf16": 0, "i8": 1, "i8f32": 2, "cast": 3}
#: B12's variants, by code of csrc/select.cu
SELECT_VARIANTS = {"astype_only": 0, "i32_min128": 1, "i32_min32": 2, "f32_min32": 3, "pack_only": 4,
                   "pack_min32": 5, "f32_minarg128": 6, "f32_minarg32": 7}
#: B13's variants, by code of csrc/bisect.cu
BISECT_VARIANTS = {"dot_only": 0, "sel_none": 1, "sel8": 2, "sel32": 3, "sel32f": 4}
#: B11: rows at most (four 64-row tiles), and the multiple of K and N
LOOP_MAX_M, LOOP_COLS = 256, 64
#: B11's blocks, in order of preference: (columns a warpgroup, warpgroups);
#: 64-column warpgroups where N is no multiple of 128, or K too wide
LOOP_BLOCKS = ((128, 2), (64, 3), (128, 1), (64, 1))
#: shared memory a block may use (csrc/wgmma_common.cuh kSmem)
SMEM_BYTES = 232448
#: B12: columns a block; its rows are staged whole in shared memory
SELECT_COLS, SELECT_MAX_W = 32, 1536
#: B13: lanes a cell, and the widest accumulator its shared memory holds
BISECT_LANES, BISECT_MAX_OUT_PAD = 128, 320


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 to int32, wrapping as two's complement arithmetic does."""
    return (((x + 2**31) & (2**32 - 1)) - 2**31).to(torch.int32)


def _seq_sum(rows: torch.Tensor) -> torch.Tensor:
    """f32 sum over the first axis in order, one rounding per addition."""
    s = rows[0].clone()
    for r in rows[1:]:
        s = s + r
    return s


def _packed_key(v: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """``((-v) << 5) | sub`` in wrapping i32 arithmetic; ``sub`` < 32."""
    return _wrap32(-v.long() * 32 + sub)


# ---------------------------------------------------------------------------
# B11
# ---------------------------------------------------------------------------


def _check_loop(a, b, mode: str, reps: int) -> None:
    if mode not in LOOP_MODES:
        raise ValueError(f"mode must be one of {tuple(LOOP_MODES)}, got {mode!r}")
    want = torch.bfloat16 if mode == "bf16" else torch.int8
    if a.dtype != want or b.dtype != want:
        raise TypeError(f"mode {mode} takes {want} operands, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a [M, K] and b [N, K] expected, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous and on one device")
    (m, k), n = a.shape, b.shape[0]
    if k > n or k * 128 * 128 > 2**24 or reps < 1:
        raise ValueError(f"need K <= N, K <= 1024 and reps >= 1, got K={k}, N={n}, reps={reps}")


def loop_matmul_plain(a: torch.Tensor, b: torch.Tensor, mode: str, reps: int) -> torch.Tensor:
    """B11 in torch: each step's product in f64, exact for integer operands."""
    _check_loop(a, b, mode, reps)
    k = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32 if mode == "i8" else torch.float32,
                      device=a.device)
    bt = b.double().T
    for _ in range(reps):
        x = a + (acc[:, :k] % 2).to(a.dtype)  # in a's own arithmetic: bf16 rounds, i8 wraps
        acc = acc + (x.double() @ bt).to(acc.dtype)
    return acc


def loop_layout(m: int, k: int, n: int, mode: str, sms: int) -> tuple:
    """B11's blocks on a card of ``sms`` SMs: ``(columns a warpgroup,
    warpgroups a block, A K-blocks in shared memory, a0 in shared memory)``.
    A block owns 64 rows of ``acc`` and the columns of its warpgroups; the
    first of `LOOP_BLOCKS` whose columns divide N, whose blocks (``ceil(M /
    64) x N / columns``) fit one an SM, and whose slice of b0 leaves room for
    two K-blocks of A (or all of them) in shared memory; the tile's rows of
    a0 stay there too where they fit beside all K-blocks of A (or two)."""
    elem = 2 if mode in ("bf16", "cast") else 1
    n_kb = -(-k * elem // 128)  # 128-byte K-blocks of a row
    tiles = -(-m // 64)
    a0_bytes = 64 * k * (2 if mode == "bf16" else 1)
    for knw, wgs in LOOP_BLOCKS:
        cols = knw * wgs
        if n % cols or tiles * (n // cols) > sms:
            continue
        room = SMEM_BYTES - 1024 - cols * n_kb * 128 - 2 * 64 * (k // 32) * 4
        need = min(n_kb, 2) * 64 * 128
        if room < need:
            continue
        resident = room - a0_bytes >= need
        return knw, wgs, min(n_kb, (room - a0_bytes * resident) // (64 * 128)), int(resident)
    raise ValueError(f"no block layout of B11 fits M={m}, K={k}, N={n} ({mode}) on {sms} SMs: the "
                     f"ceil(M / 64) x N / columns blocks of {LOOP_BLOCKS} must fit one an SM")


def _loop_launch(entry: str, a: torch.Tensor, b: torch.Tensor, mode: str, reps: int) -> torch.Tensor:
    """One launch of csrc/matmul_probe.cu's ``entry`` on CUDA tensors."""
    from .. import build

    (m, k), n = a.shape, b.shape[0]
    if m % 16 or m > LOOP_MAX_M or k % LOOP_COLS or n % LOOP_COLS or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"the kernel takes M % 16 == 0, M <= {LOOP_MAX_M}, K and N multiples of {LOOP_COLS} and "
                         f"16-byte aligned operands, got {m}, {k}, {n}")
    knw, wgs, slots, resident = loop_layout(m, k, n, mode,
                                            torch.cuda.get_device_properties(a.device).multi_processor_count)
    mp = -(-m // 64) * 64
    out = torch.empty((m, n), dtype=torch.int32 if mode == "i8" else torch.float32, device=a.device)
    bits = torch.empty((reps, mp, k // 32), dtype=torch.int32, device=a.device)
    flags = torch.zeros((mp // 64, reps), dtype=torch.int32, device=a.device)
    lib = build.load("matmul_probe")
    with torch.cuda.device(a.device):
        _launch(getattr(lib, entry), _ptr(a), _ptr(b), _ptr(out), _ptr(bits), _ptr(flags), m, k, n, reps,
                LOOP_MODES[mode], knw, wgs, slots, resident, _stream())
    return out


def loop_matmul(a: torch.Tensor, b: torch.Tensor, mode: str, reps: int) -> torch.Tensor:
    """Kernel B11 (csrc/matmul_probe.cu `usearch_loop_matmul`), or its plain
    version for CPU tensors: ``acc`` after ``reps`` loop-carried products,
    ``[M, N]`` i32 (``i8``) or f32. On the card ``M`` is a multiple of 16 up
    to 256, ``K`` and ``N`` multiples of 64, and the blocks of
    `loop_layout` must fit on the card at once (one per SM)."""
    _check_loop(a, b, mode, reps)
    if a.device.type == "cpu":
        return loop_matmul_plain(a, b, mode, reps)
    out = _loop_launch("usearch_loop_matmul", a, b, mode, reps)
    loop_matmul.launches += 1
    return out


loop_matmul.launches = 0


def loop_chain(a: torch.Tensor, b: torch.Tensor, mode: str, reps: int) -> torch.Tensor:
    """B11 with its product taken out (csrc/matmul_probe.cu
    `usearch_loop_chain`), on the card only: the same blocks, steps and
    step-to-step handshake, ``acc`` 0 throughout. Its time is the floor of
    B11's step chain without the product; not a kernel of any path, so it
    counts no launches and has no plain version."""
    _check_loop(a, b, mode, reps)
    if a.device.type != "cuda":
        raise ValueError("loop_chain times the card's handshake: it takes CUDA tensors")
    return _loop_launch("usearch_loop_chain", a, b, mode, reps)


# ---------------------------------------------------------------------------
# B12
# ---------------------------------------------------------------------------


def _check_select(x, variant: str, iters: int) -> None:
    if variant not in SELECT_VARIANTS:
        raise ValueError(f"variant must be one of {tuple(SELECT_VARIANTS)}, got {variant!r}")
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [W, G] int32 tensor, got {x.dtype} {tuple(x.shape)}")
    w = x.shape[0]
    if w % 128 or w == 0 or iters < 1:
        raise ValueError(f"need W a positive multiple of 128 and iters >= 1, got W={w}, iters={iters}")


def _select_row(x: torch.Tensor, variant: str) -> torch.Tensor:
    """Row 0 of one B12 pass over ``x`` (already ``x + i``)."""
    w, g = x.shape
    gs = 128 if variant.endswith("128") else 32
    if variant == "astype_only":
        return _seq_sum(x[:8].float())
    if variant in ("i32_min128", "i32_min32"):
        return _wrap32(x.view(w // gs, gs, g).amin(1).long().sum(0)).float()
    if variant == "f32_min32":
        return _seq_sum(x.float().view(w // gs, gs, g).amin(1))
    sub = (torch.arange(w, device=x.device) & 31)[:, None]
    if variant == "pack_only":
        return _wrap32(_packed_key(x, sub)[::32].long().sum(0)).float()
    if variant == "pack_min32":
        return _wrap32(_packed_key(x, sub).view(w // gs, gs, g).amin(1).long().sum(0)).float()
    x3 = x.float().view(w // gs, gs, g)
    return _seq_sum(x3.amin(1)) + _wrap32(x3.argmin(1).sum(0)).float()  # the first arg-minimum


def select_loop_plain(x: torch.Tensor, variant: str, iters: int) -> torch.Tensor:
    """B12 in torch, pass by pass."""
    _check_select(x, variant, iters)
    out = torch.zeros((8, x.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(iters):
        out[0] = _select_row(x + i, variant)
    return out


def select_loop(x: torch.Tensor, variant: str, iters: int) -> torch.Tensor:
    """Kernel B12 (csrc/select.cu `usearch_select_loop`), or its plain
    version for CPU tensors: the f32 ``[8, G]`` output after ``iters``
    passes. On the card ``G`` is a multiple of 32 and ``W`` at most 1,536."""
    _check_select(x, variant, iters)
    if x.device.type == "cpu":
        return select_loop_plain(x, variant, iters)
    from .. import build

    w, g = x.shape
    if g % SELECT_COLS or w > SELECT_MAX_W or x.data_ptr() % 16:
        raise ValueError(f"the kernel takes G % {SELECT_COLS} == 0, W <= {SELECT_MAX_W} and 16-byte aligned rows, "
                         f"got G={g}, W={w}")
    out = torch.zeros((8, g), dtype=torch.float32, device=x.device)
    lib = build.load("select")
    with torch.cuda.device(x.device):
        _launch(lib.usearch_select_loop, _ptr(x), _ptr(out), w, g, iters, SELECT_VARIANTS[variant], _stream())
    select_loop.launches += 1
    return out


select_loop.launches = 0


def select_blocks(g: int, variant: str, device) -> int:
    """Blocks of B12's grid for ``G = g`` columns and ``variant`` on the
    CUDA ``device`` (csrc/select.cu `usearch_select_blocks`): the G/32
    column groups times the pass groups, enough to fill the card's SMs, but
    1 for astype_only and 8 for pack_only, which read a few rows a pass."""
    from .. import build

    if g <= 0 or g % SELECT_COLS or variant not in SELECT_VARIANTS:
        raise ValueError(f"G must be a positive multiple of {SELECT_COLS} and the variant one of "
                         f"{tuple(SELECT_VARIANTS)}, got {g} and {variant!r}")
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _launch(build.load("select").usearch_select_blocks, g, SELECT_VARIANTS[variant], ctypes.byref(blocks))
    return blocks.value


# ---------------------------------------------------------------------------
# B13
# ---------------------------------------------------------------------------


def bisect_bins(variant: str, w_pad: int) -> int:
    """Accumulator entries a B13 variant writes."""
    return {"dot_only": 8, "sel8": w_pad // 8}.get(variant, w_pad // 32)


def _check_bisect(meta, q, qa, table, variant: str, w_pad: int, out_pad: int) -> None:
    if variant not in BISECT_VARIANTS:
        raise ValueError(f"variant must be one of {tuple(BISECT_VARIANTS)}, got {variant!r}")
    if meta.dtype != torch.int32 or meta.dim() != 3 or meta.shape[1] < 4 or meta.shape[2] != BISECT_LANES:
        raise ValueError(f"meta must be int32 [cells, 8, {BISECT_LANES}], got {meta.dtype} {tuple(meta.shape)}")
    p = meta.shape[0] * BISECT_LANES
    if q.dtype != torch.int8 or table.dtype != torch.int8 or q.dim() != 2 or table.dim() != 2:
        raise ValueError("q [P, D] and table [rows, D] must be int8")
    if q.shape != (p, table.shape[1]) or qa.dtype != torch.float32 or qa.shape != (p, 8):
        raise ValueError(f"q [{p}, D] and qa [{p}, 8] f32 expected, got {tuple(q.shape)} and {tuple(qa.shape)}")
    if len({t.device for t in (meta, q, qa, table)}) != 1 or not all(
            t.is_contiguous() for t in (meta, q, qa, table)):
        raise ValueError("meta, q, qa and table must be contiguous and on one device")
    if w_pad <= 0 or w_pad % 64 or bisect_bins(variant, w_pad) > out_pad:
        raise ValueError(f"need w_pad a positive multiple of 64 and out_pad >= {bisect_bins(variant, max(w_pad, 0))}"
                         f" for {variant}, got w_pad={w_pad}, out_pad={out_pad}")


def _bisect_select(dots: torch.Tensor, variant: str) -> torch.Tensor:
    """The ``[n_win, nb, G]`` f32 entries a select variant keeps, from the
    windows' ``[n_win, w_pad, G]`` int32 dots."""
    n_win, w_pad, g = dots.shape
    if variant == "sel_none":
        return dots[:, ::32].float()
    if variant == "sel8":
        return dots.view(n_win, w_pad // 8, 8, g).amin(2).float()
    if variant == "sel32":
        sub = (torch.arange(w_pad, device=dots.device) & 31)[None, :, None]
        return _packed_key(dots, sub).view(n_win, w_pad // 32, 32, g).amin(2).float()
    d3 = dots.float().view(n_win, w_pad // 32, 32, g)
    return d3.amin(2) + d3.argmin(2).float()  # the first arg-minimum


def bisect_probe_plain(meta, q, qa, table, variant: str, w_pad: int, out_pad: int,
                       init: float = MASKED) -> torch.Tensor:
    """B13 in torch, cell by cell; the dots in f64, exact."""
    _check_bisect(meta, q, qa, table, variant, w_pad, out_pad)
    cells, g = meta.shape[0], BISECT_LANES
    n_rows = table.shape[0]
    out = torch.full((cells * g, out_pad), init, dtype=torch.float32, device=q.device)
    meta_h = meta[:, [0, 3]].cpu()
    span = torch.arange(w_pad, device=q.device)
    for c in range(cells):
        n_win = int(meta_h[c, 1, 0])
        if n_win <= 0:
            continue
        st = meta_h[c, 0, torch.arange(n_win).clamp(max=g - 1)].long()
        keep = (st >= 0) & (st <= n_rows - w_pad)  # windows inside the table
        w_ids, st = torch.nonzero(keep).flatten().to(q.device), st[keep].to(q.device)
        if len(st) == 0:
            continue
        rows = table[st[:, None] + span].double()  # [n_win, w_pad, D]
        dots = torch.einsum("wrd,ld->wrl", rows, q[c * g:(c + 1) * g].double()).round().to(torch.int32)
        acc = torch.full((out_pad, g), init, dtype=torch.float32, device=q.device)
        if variant == "dot_only":
            for d in dots[:, :8].float():
                acc[:8] = acc[:8] + d
        else:
            # each lane keeps the entries of the last window it owns
            own = qa[c * g:(c + 1) * g, 2][None, :] == w_ids[:, None].float()  # [n_win, G]
            last = torch.where(own, torch.arange(len(st), device=q.device)[:, None], -1).amax(0)
            v = _bisect_select(dots, variant)  # [n_win, nb, G]
            nb = v.shape[1]
            picked = v[last.clamp(min=0), :, torch.arange(g, device=q.device)]  # [G, nb]
            acc[:nb] = torch.where(last[None, :] >= 0, picked.T, acc[:nb])
        out[c * g:(c + 1) * g] = acc.T
    return out


def bisect_probe(meta, q, qa, table, variant: str, w_pad: int, out_pad: int,
                 init: float = MASKED) -> torch.Tensor:
    """Kernel B13 (csrc/bisect.cu `usearch_bisect_probe`), or its plain
    version for CPU tensors: the ``[cells * 128, out_pad]`` f32 output. On
    the card the rows are a multiple of 128 bytes wide and ``out_pad`` at
    most 320."""
    _check_bisect(meta, q, qa, table, variant, w_pad, out_pad)
    if q.device.type == "cpu":
        return bisect_probe_plain(meta, q, qa, table, variant, w_pad, out_pad, init)
    from .. import build

    (n_rows, width), cells = table.shape, meta.shape[0]
    if width % 128 or out_pad > BISECT_MAX_OUT_PAD:
        raise ValueError(f"the kernel takes rows of a multiple of 128 bytes and out_pad <= {BISECT_MAX_OUT_PAD},"
                         f" got {width} and {out_pad}")
    out = torch.empty((cells * BISECT_LANES, out_pad), dtype=torch.float32, device=q.device)
    if cells == 0:
        return out
    lib = build.load("bisect")
    with torch.cuda.device(q.device):
        _launch(lib.usearch_bisect_probe, _ptr(meta), _ptr(q), _ptr(qa), _ptr(table), _ptr(out), cells,
                meta.shape[1], n_rows, width, w_pad, out_pad, BISECT_VARIANTS[variant], ctypes.c_float(init),
                _stream())
    bisect_probe.launches += 1
    return out


bisect_probe.launches = 0
