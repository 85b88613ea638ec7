#!/usr/bin/env python3
"""Time the layouts of `pairs_quad` and `quad_strip` on one card.

    python3 tools/quad_list_layouts.py [--layouts 2x512,2x256,2x512x8,4x512]
        [--parent DIR]

Both run csrc/tree.cu's quad_list_kernel, whose layout is two constants:
QL_TARGETS (targets a thread; a block holds ceil(leaf / QL_TARGETS)
threads in whole warps) and QL_WINDOW (slots whose live ids are packed and
staged behind one barrier), and the unroll of its pair loop (`#pragma
unroll (PAIRS / NT)`: PAIRS pairs a trip). For each layout TARGETSxWINDOW
(the source's PAIRS), or TARGETSxWINDOWxPAIRS, the script builds a copy of
csrc/ with those set (nvcc, one process a layout, all started together;
with `--parent`, also that tree's csrc/tree.cu), and reports ptxas'
registers and spills and the pair loop's SASS (`chip_smoke.sass_loops`)
of the float32 instance. It then primes the tree
at tree-1M (`fixed_cloud(1_000_000)`, two far levels, pair lists) and
strip-1M (the same in strip mode) with `chip_smoke.TREE`'s settings, and
times each library by CUDA events, in two rounds (in order, then
reversed): `pairs_quad` and `quad_strip` through the port's wrappers
(`cuda_tree.near_pairs_quad`, `cuda_tree.quad_strip`, as `chip_smoke.py`'s
kernels line times them), `quad_strip`'s kernel alone through its C entry
(without the wrapper's range check, a host readback), and both with the
target clusters taken heaviest first (`cuda_tree.heavy_first` of their
live ids: the inputs permuted so that block b takes the b-th heaviest
cluster, the output permuted back). Every library's and order's output
must equal the first layout's bit for bit. It also times the range check
alone (`cuda_tree._check_near_list`) and strip-1M's steps with and without
it (`check_in_steps`), and counts the windows each block walks at each
window size. One JSON line a library, then a summary line
with the card's name and power limit. Needs one CUDA card; exits 2
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

SOURCE = (HERE / "spacetpu_torch" / "csrc" / "tree.cu").read_text()
KERNEL = "__global__ void quad_list_kernel("
#: the pair loop's unroll in quad_list_kernel: PAIRS / NT summaries a trip
UNROLL = re.compile(r"#pragma unroll \((\d+) / NT\)")


def build_libraries(layouts, parent, root: pathlib.Path) -> dict:
    """A library for each (targets, window) of this tree's csrc/, and for
    the parent's tree.cu under the key "parent", built in parallel:
    {key: (path, nvcc's log)}."""
    from spacetpu_torch import _build

    sources = {}
    for targets, window, pairs in layouts:
        text, n = re.subn(r"constexpr int QL_TARGETS = \d+;",
                          f"constexpr int QL_TARGETS = {targets};", SOURCE)
        text, k = re.subn(r"constexpr int QL_WINDOW = \d+;",
                          f"constexpr int QL_WINDOW = {window};", text)
        unroll = UNROLL.search(text, text.index(KERNEL))
        if (n, k) != (1, 1) or unroll is None:
            raise SystemExit("quad_list_layouts: tree.cu has no QL_TARGETS "
                             "or QL_WINDOW constant or no quad_list_kernel")
        text = (text[:unroll.start()] + f"#pragma unroll ({pairs} / NT)"
                + text[unroll.end():])
        sources[(targets, window, pairs)] = (text, _build.CSRC)
    if parent:
        csrc = pathlib.Path(parent) / "spacetpu_torch" / "csrc"
        sources["parent"] = ((csrc / "tree.cu").read_text(), csrc)
    jobs = {}
    for key, (text, csrc) in sources.items():
        d = root / ("parent" if key == "parent" else "%dx%dx%d" % key)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "tree.cu").write_text(text)
        so = d / "tree.so"
        jobs[key] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", str(so), str(d / "tree.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"quad_list_layouts: nvcc failed for {key}:\n"
                             + log)
        out[key] = (str(so), log)
    return out


def primed_prep(dev, n, cs, **kw):
    """The prep of a primed simulation of fixed_cloud(n) (n + 1 bodies) at
    chip_smoke's tree settings (and `kw`), its scene's g, the simulation
    and its primed state."""
    import torch

    import spacetpu_torch as st
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import tree as tree_ops

    scene = presets.fixed_cloud(n)
    sim = st.make_simulation(scene.n, g=scene.g, device=dev,
                             **dict(cs.TREE, **kw))
    state = sim.prime(scene.state(dtype=torch.float32, device=dev))
    return (tree_ops.tree_prep(state.pos, state.mass, **sim._prep_kw()),
            scene.g, sim, state)


def heavy_pairs_inputs(pos_g, summ, flat, tile_tgt):
    """pairs_quad's inputs with the target clusters heaviest first (by
    their live ids) and the order: cluster b of the new inputs is cluster
    order[b], its tiles those of the old one, in order."""
    import torch

    from spacetpu_torch.ops import cuda_tree

    gg = pos_g.shape[0]
    n_src = summ.shape[1] - 1
    pj = flat.numel() // tile_tgt.numel()
    starts = cuda_tree.tile_starts(tile_tgt, gg)
    ntiles = starts[1:] - starts[:-1]
    tiles = flat.reshape(-1, pj)
    live = ((tiles >= 0) & (tiles < n_src)).sum(1)
    keep = tile_tgt < gg
    work = torch.zeros(gg, dtype=torch.int64, device=pos_g.device)
    work.index_add_(0, tile_tgt[keep], live[keep])
    order = cuda_tree.heavy_first(work)
    counts = ntiles[order]
    first = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    step = torch.arange(total, device=pos_g.device)
    which = torch.repeat_interleave(
        torch.arange(gg, device=pos_g.device), counts)
    old = starts[order][which] + step - first[which]
    return (pos_g[order], summ, tiles[old].reshape(-1), which), order


def check_in_steps(sim, state, cs, steps=5) -> dict:
    """strip-1M's ms a step (host clock, ending in a synchronize) with
    quad_strip's range check and with it left out (`_check_near_list` a
    no-op inside `cuda_tree.quad_strip` alone; near_strip keeps its own),
    in turns: with, without, without, with."""
    import time

    import torch

    from spacetpu_torch.ops import cuda_tree

    check, strip = cuda_tree._check_near_list, cuda_tree.quad_strip

    def unchecked(*args, **kw):
        cuda_tree._check_near_list = lambda *a, **k: None
        try:
            return strip(*args, **kw)
        finally:
            cuda_tree._check_near_list = check

    out = {"with": [], "without": []}
    try:
        for turn in ("with", "without", "without", "with"):
            cuda_tree.quad_strip = strip if turn == "with" else unchecked
            state = sim.step(state, cs.DT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state = sim.step(state, cs.DT)
            torch.cuda.synchronize()
            out[turn].append(1e3 * (time.perf_counter() - t0) / steps)
    finally:
        cuda_tree.quad_strip = strip
    return out


def window_counts(lengths, windows) -> dict:
    """For each window size: the mean windows a block walks and the share
    of blocks that walk more than one, over ranges of `lengths` slots."""
    out = {}
    for w in windows:
        n = (lengths + w - 1) // w
        out[str(w)] = {"mean": float(n.double().mean()),
                       "share_over_one": float((n > 1).double().mean())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="2x512,2x256,2x1024,4x512",
                    help="comma-separated TARGETSxWINDOW")
    ap.add_argument("--parent", help="root of another tree whose tree.cu is "
                    "timed beside the layouts (the parent commit)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("quad_list_layouts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spacetpu_torch import _build
    from spacetpu_torch.ops import cuda_tree

    unroll = UNROLL.search(SOURCE, SOURCE.index(KERNEL)).group(1)
    layouts = [tuple(int(v) for v in (s.split("x") + [unroll])[:3])
               for s in args.layouts.split(",")]
    dev = torch.device("cuda")
    card = cs.phase_device(dev, False)
    built = build_libraries(layouts, args.parent,
                            _build.BUILD_DIR / "quad_list_layouts")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    rows = {}
    for key, (so, log) in built.items():
        row = {"library": "parent" if key == "parent" else "%dx%dx%d" % key}
        if key != "parent":
            tag = f"quad_list_kernelIfLi{key[0]}EE"
            ptx = next(k for k in cs.ptxas_summary(log)
                       if tag in k["function"])
            loop = next(v for f, v in cs.sass_loops(cuobjdump, so).items()
                        if tag in f)
            row.update(targets=key[0], window=key[1], loop_pairs=key[2],
                       registers=ptx.get("registers"),
                       spill_stores=ptx.get("spill_stores", 0),
                       loop_instructions=loop["instructions"],
                       sass_per_pair=loop["instructions"] / key[2],
                       loop_mufu=loop["ops"].get("MUFU", 0))
        rows[key] = row

    eps = cs.TREE["eps"]
    prep, g, _, _ = primed_prep(dev, 1_000_000, cs)
    x = cs.tree_inputs(prep, g)
    q_args = (prep["pos_g"], x["neg"], prep["nearq_flat"],
              prep["nearq_tile_tgt"])
    q_heavy, q_order = heavy_pairs_inputs(*q_args)
    prep_s, g_s, sim_s, state_s = primed_prep(dev, 1_000_000, cs,
                                              near_mode="strip")
    s_args = cs.strip_inputs(prep_s, g_s)["quad"]
    pos_t, neg_s, idx = s_args
    n_src = neg_s.shape[1] - 1
    s_order = cuda_tree.heavy_first((idx < n_src).sum(1))
    s_heavy = (pos_t[s_order].contiguous(), neg_s,
               idx[s_order].contiguous())
    gg, leaf = prep["pos_g"].shape[:2]
    gs = pos_t.shape[0]
    live_q = int(((q_args[2] >= 0) & (q_args[2] < gg)).sum())
    live_s = int((idx < n_src).sum())
    pairs = {"pairs_quad": float(live_q) * leaf,
             "quad_strip": float(live_s) * pos_t.shape[1]}

    def unpermute(out, order, g_):
        back = torch.empty_like(out.reshape(g_, -1, 3))
        back[order] = out.reshape(g_, -1, 3)
        return back.reshape(out.shape)

    def strip_kernel():
        """quad_strip's C entry alone, the wrapper's arguments."""
        out = pos_t.new_empty((gs * pos_t.shape[1], 3))
        rc = cuda_tree._lib().spacetpu_quad_strip(
            0, pos_t.data_ptr(), neg_s.data_ptr(), neg_s.stride(0),
            idx.data_ptr(), out.data_ptr(), gs, pos_t.shape[1],
            idx.shape[1], n_src, float(eps), cuda_tree._stream(dev))
        if rc:
            raise SystemExit(f"quad_list_layouts: quad_strip error {rc}")
        return out

    calls = {
        "pairs_quad": lambda: cuda_tree.near_pairs_quad(*q_args, eps=eps),
        "pairs_quad_heavy": lambda: unpermute(
            cuda_tree.near_pairs_quad(*q_heavy, eps=eps), q_order, gg),
        "quad_strip": lambda: cuda_tree.quad_strip(*s_args, eps=eps),
        "quad_strip_kernel": strip_kernel,
        "quad_strip_heavy": lambda: unpermute(
            cuda_tree.quad_strip(*s_heavy, eps=eps), s_order, gs),
    }
    first = {}
    keys = list(built)
    for key in keys + keys[::-1]:
        _build._libs["tree"] = ctypes.CDLL(built[key][0])
        row = rows[key]
        for name, call in calls.items():
            got = call()
            want = first.setdefault(name.split("_heavy")[0].split(
                "_kernel")[0], got)
            if not torch.equal(got, want):
                raise SystemExit(f"quad_list_layouts: {name} of {key} "
                                 "differs from the first library's bits")
            row.setdefault(f"{name}_ms", []).append(cs.cuda_ms(call, 20))
    for key in keys:
        row = rows[key]
        if "loop_instructions" in row:
            for name in ("pairs_quad", "quad_strip"):
                row[f"{name}_issue_bound_ms"] = cs.issue_fields(
                    {name: row["sass_per_pair"]
                     * cs.PAIRS_PER_LOOP.get(name, 8)}, name, pairs[name],
                    card)["issue_bound_ms"]
        print(json.dumps(row), flush=True)
    starts = cuda_tree.tile_starts(q_args[3], gg)
    q_len = (starts[1:] - starts[:-1]) * (q_args[2].numel()
                                          // q_args[3].numel())
    windows = sorted({w for _, w, _ in layouts})
    step_ms = check_in_steps(sim_s, state_s, cs)
    summary = {
        "shapes": {"pairs_quad": [gg, leaf, live_q],
                   "quad_strip": [gs, pos_t.shape[1], idx.shape[1], live_s]},
        "pairs": pairs, "eps": eps,
        "range_check_ms": cs.cuda_ms(lambda: cuda_tree._check_near_list(
            "idx", idx, pos_t, gs, n_src), 20),
        "strip_step_ms": step_ms,
        "windows_a_block": {
            "pairs_quad": window_counts(q_len, windows),
            "quad_strip": window_counts(
                torch.full((gs,), idx.shape[1], dtype=torch.int64), windows)},
        "nvidia_smi": card["smi"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
