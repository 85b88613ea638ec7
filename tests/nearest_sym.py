"""The schedule of `nearest_neighbor`'s kernels (`csrc/encounter.cu`),
emulated in PyTorch on the CPU for the tests: the diagonal tiles, the bands
of the half ring (`energy.potential_bands`), each unordered tile pair
evaluated once with its row and column candidates, and the join of the
column slots. Not on the port's path.

`emulate` meets the candidates in the kernels' order: a block of R = 32 P
rows, every warp holding all of them (lane l row 32 k + l), warp w sweeping
the chunks w CHUNKS + c of each tile of its band, the wrapped tiles (J < I)
first; a row keeps its least by a strict < in that order, a column its
least over a lane's rows by a strict < in k, then over the lanes, the
warps, the bands and the slots by the lexicographic compare, as the
kernels do. `wrong` names a schedule that must fail: "no_columns" drops the
column candidates, "visit_order" takes a band's offsets in increasing d
(the wrapped tiles last), "strict_join" joins the lanes, warps and slots by
a strict < on r^2 alone.

`merge_loop_full` is the merge loop with a full search a merge (a loop of
`collisions.merge_closest`), which the CPU tests, the card tests and
chip_smoke.py hold `collisions.merge_all_overlapping` against bit for bit
(`same_merges`).
"""

from __future__ import annotations

import torch

from spacetpu_torch.ops import collisions, encounters, energy


def _lex_take(v, a, bv, ba, wrong):
    """Where (v, a) takes over (bv, ba) by the kernels' join."""
    if wrong == "strict_join":
        return v < bv
    return (v < bv) | ((v == bv) & (a < ba))


def emulate(pos, mask=None, *, p: int, warps: int, slots: int, wrong=None):
    """(best_r2, idx) of every body by the kernels' schedule with lanes of
    `p` rows, `warps` warps a block and bands of at most `slots` offsets."""
    n = pos.shape[0]
    rows = 32 * p
    chunks = p // warps
    nblk = -(-n // rows)
    pad = nblk * rows - n
    inf = torch.tensor(torch.inf, dtype=pos.dtype)
    live = torch.ones(n, dtype=torch.bool) if mask is None else mask
    # rows and columns past N: dead bodies at the origin
    pp = torch.cat([pos, pos.new_zeros((pad, 3))])
    pen = torch.where(torch.cat([live, torch.zeros(pad, dtype=torch.bool)]),
                      torch.zeros((), dtype=pos.dtype), inf)
    blocks = torch.arange(nblk)

    # the diagonal tiles: every ordered pair, in column order, self by index
    tiles = pp.reshape(nblk, rows, 3)
    diag = torch.stack([encounters._r2(t, t) for t in tiles])  # (B, R, R)
    diag = diag + pen.reshape(nblk, 1, rows)
    diag[:, torch.arange(rows), torch.arange(rows)] = torch.inf
    bv = torch.full((nblk, rows), torch.inf, dtype=pos.dtype)
    bi = torch.zeros((nblk, rows), dtype=torch.int64)
    for c in range(rows):
        take = diag[:, :, c] < bv
        bv = torch.where(take, diag[:, :, c], bv)
        bi = torch.where(take, (blocks * rows + c)[:, None], bi)
    best, idx = bv.reshape(-1), bi.reshape(-1)

    bands = energy.potential_bands(n, rows, slots)
    width_max = max((hi - lo + 1 for lo, hi in bands), default=0)
    slot_v = torch.full((width_max, nblk * rows), torch.inf, dtype=pos.dtype)
    slot_i = torch.zeros((width_max, nblk * rows), dtype=torch.int64)
    row_pos = pp.reshape(nblk, rows, 3)
    row_dead = (pen != 0).reshape(nblk, rows)
    for d_lo, d_hi in bands:
        width = d_hi - d_lo + 1
        unwrapped = (nblk - blocks - d_lo).clamp(0, width)
        wrapped = width - unwrapped
        # each warp's running least of every row of its block
        rb = torch.full((warps, nblk, rows), torch.inf, dtype=pos.dtype)
        ra = torch.zeros((warps, nblk, rows), dtype=torch.int64)
        for t in range(width):
            if wrong == "visit_order":
                d = torch.full((nblk,), d_lo + t)
            else:
                d = torch.where(t < wrapped, d_lo + unwrapped + t,
                                d_lo + t - wrapped)
            on = ~((2 * d == nblk) & (blocks >= d))
            jt = (blocks + d) % nblk
            for w in range(warps):
                for c in range(chunks):
                    j0 = jt * rows + 32 * (w * chunks + c)
                    cols = j0[:, None] + torch.arange(32)[None, :]  # (B, 32)
                    cpos = pp[cols]  # (B, 32, 3)
                    # r^2 of every (row, column): target row, source column
                    r2 = torch.stack([encounters._r2(row_pos[b], cpos[b])
                                      for b in range(nblk)])  # (B, R, 32)
                    # the rows: strict < in column order
                    for jj in range(32):
                        rc = r2[:, :, jj] + pen[cols[:, jj]][:, None]
                        take = (rc < rb[w]) & on[:, None]
                        rb[w] = torch.where(take, rc, rb[w])
                        ra[w] = torch.where(take, cols[:, jj][:, None],
                                            ra[w])
                    if wrong == "no_columns":
                        continue
                    # the columns: strict < over a lane's rows in k order
                    cc = torch.where(row_dead[:, :, None], inf, r2)
                    cc = cc.reshape(nblk, p, 32, 32)  # (B, k, lane, column)
                    cb, ck = cc[:, 0], torch.zeros_like(cc[:, 0],
                                                        dtype=torch.int64)
                    for k in range(1, p):
                        tk = cc[:, k] < cb
                        cb = torch.where(tk, cc[:, k], cb)
                        ck = torch.where(tk, k, ck)
                    ridx = 32 * ck + torch.arange(32)[None, :, None]
                    # the lanes of a column, in lane order, by the join
                    v, r = cb[:, 0], ridx[:, 0]
                    for g in range(1, 32):
                        tk = _lex_take(cb[:, g], ridx[:, g], v, r, wrong)
                        v = torch.where(tk, cb[:, g], v)
                        r = torch.where(tk, ridx[:, g], r)
                    gi = (blocks * rows)[:, None] + r
                    s = (d - d_lo)[:, None].expand(-1, 32)
                    cur_v, cur_i = slot_v[s, cols], slot_i[s, cols]
                    tk = _lex_take(v, gi, cur_v, cur_i, wrong) & on[:, None]
                    tk &= cols < n
                    slot_v[s, cols] = torch.where(tk, v, cur_v)
                    slot_i[s, cols] = torch.where(tk, gi, cur_i)
        # the band's end: each row over its warps, into (best, idx)
        bv, bi = best.reshape(nblk, rows), idx.reshape(nblk, rows)
        for w in range(warps):
            tk = _lex_take(rb[w], ra[w], bv, bi, wrong)
            bv = torch.where(tk, rb[w], bv)
            bi = torch.where(tk, ra[w], bi)
        best, idx = bv.reshape(-1), bi.reshape(-1)
    # the join: the slots into the rows
    for s in range(width_max):
        tk = _lex_take(slot_v[s], slot_i[s], best, idx, wrong)
        best = torch.where(tk, slot_v[s], best)
        idx = torch.where(tk, slot_i[s], idx)
    return best[:n], idx[:n]


def merge_loop_full(state, radii, max_merges=8):
    """The merge loop as it stood before the table was kept across merges:
    a loop of merge_closest, a full nearest-neighbour search a merge."""
    n_merged, e_lost = 0, 0.0
    for _ in range(max_merges):
        r = collisions.merge_closest(state, radii)
        if not bool(r.merged):
            break
        state, radii = r.state, r.radii
        e_lost += float(r.energy_lost)
        n_merged += 1
    return state, radii, n_merged, e_lost


def same_merges(a, b) -> bool:
    """Whether two merge loops' (state, radii, n_merged, energy_lost) are
    the same, bit for bit."""
    return (a[2:] == b[2:] and torch.equal(a[1], b[1])
            and all(x is None and y is None or torch.equal(x, y)
                    for x, y in zip(a[0], b[0])))
