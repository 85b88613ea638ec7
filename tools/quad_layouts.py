#!/usr/bin/env python3
"""Time the block layouts of `quad_dense` and `quad_masked` on one card.

    python3 tools/quad_layouts.py [--layouts 256x2,128x2,256x4,128x4]

Both run csrc/tree.cu's quad_two_kernel, whose layout is two constants:
QUAD_THREADS (threads a block) and QUAD_TARGETS (targets a thread). For
each layout THREADSxTARGETS the script builds a copy of csrc/ with those
two set (nvcc, one process a layout, all started together), and reports
ptxas' registers and spills and the pair loop's SASS (`chip_smoke.
sass_loops`) of both float32 instances. It then primes the tree at
tree-1M (`fixed_cloud(1_000_000)`, two far levels) and far3-4M
(`fixed_cloud(4_000_000)`, three) with `chip_smoke.TREE`'s settings, and
times each layout's library through the port's own wrappers
(`cuda_tree.acc_cross_quad` and `acc_cross_quad_masked`) on those inputs by
CUDA events, in two rounds (the layouts in order, then reversed). Every
layout's output must equal the first layout's bit for bit. It also times
the two ways to hand `quad_masked` its mask, each built on the device from
the same near-super lists: the (n2, G2) keep mask of one scatter
(`cuda_tree._keep_mask`, what the wrapper does) and a list of kept column
ids a super with each 256-column tile's offsets into it (a sort and a
search). One JSON line a layout, then a summary line with the card's name
and power limit. Needs one CUDA card; exits 2 without one.
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


def build_layouts(layouts, root: pathlib.Path) -> dict:
    """A library of csrc/ for each (threads, targets), built in parallel:
    {layout: (path, nvcc's log)}."""
    from spacetpu_torch import _build

    src = (_build.CSRC / "tree.cu").read_text()
    jobs = {}
    for threads, targets in layouts:
        d = root / f"{threads}x{targets}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        text, n = re.subn(r"constexpr int QUAD_THREADS = \d+;",
                          f"constexpr int QUAD_THREADS = {threads};", src)
        text, k = re.subn(r"constexpr int QUAD_TARGETS = \d+;",
                          f"constexpr int QUAD_TARGETS = {targets};", text)
        if (n, k) != (1, 1):
            raise SystemExit("quad_layouts: tree.cu has no QUAD_THREADS or "
                             "QUAD_TARGETS constant")
        (d / "tree.cu").write_text(text)
        so = d / "tree.so"
        jobs[(threads, targets)] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", str(so), str(d / "tree.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for layout, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"quad_layouts: nvcc failed for {layout}:\n"
                             + log)
        out[layout] = (str(so), log)
    return out


def primed_inputs(dev, n, cs):
    """The prep of a primed simulation of fixed_cloud(n) (n + 1 bodies) at
    chip_smoke's tree settings, and its scene's g."""
    import torch

    import spacetpu_torch as st
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import tree as tree_ops

    scene = presets.fixed_cloud(n)
    sim = st.make_simulation(scene.n, g=scene.g, device=dev, **cs.TREE)
    state = sim.prime(scene.state(dtype=torch.float32, device=dev))
    return tree_ops.tree_prep(state.pos, state.mass, **sim._prep_kw()), \
        scene.g


def kept_lists(idx2, g2: int, tile: int = 256):
    """The other way to hand quad_masked its mask: a super's kept column
    ids in order (G2 pads each row's end) and, for each tile of `tile`
    columns, where its ids start in the row, built on the device from the
    near-super lists by a sort and a search."""
    import torch

    from spacetpu_torch.ops import cuda_tree

    keep = cuda_tree._keep_mask(idx2, g2)
    cols = torch.arange(g2, device=idx2.device).expand_as(keep)
    ids = torch.sort(torch.where(keep, cols, g2), dim=1).values
    edges = torch.arange(0, g2 + tile, tile,
                         device=idx2.device).clamp_max(g2)
    starts = torch.searchsorted(ids, edges.expand(ids.shape[0], -1)
                                .contiguous())
    return ids, starts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="256x2,128x2,256x4,128x4",
                    help="comma-separated THREADSxTARGETS")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("quad_layouts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spacetpu_torch import _build
    from spacetpu_torch.ops import cuda_tree

    layouts = [tuple(int(v) for v in s.split("x"))
               for s in args.layouts.split(",")]
    dev = torch.device("cuda")
    card = cs.phase_device(dev, False)
    built = build_layouts(layouts, _build.BUILD_DIR / "quad_layouts")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    rows = {}
    for (threads, targets), (so, log) in built.items():
        loops = cs.sass_loops(cuobjdump, so)
        row = {"layout": f"{threads}x{targets}", "threads": threads,
               "targets": targets}
        for name, masked in (("quad_dense", 0), ("quad_masked", 1)):
            tag = f"quad_two_kernelIfLb{masked}ELi{targets}EE"
            ptx = next(k for k in cs.ptxas_summary(log)
                       if tag in k["function"])
            loop = next(v for f, v in loops.items() if tag in f)
            row[name] = {"registers": ptx.get("registers"),
                         "spill_stores": ptx.get("spill_stores", 0),
                         "loop_instructions": loop["instructions"],
                         "sass_per_pair": loop["instructions"] / 8,
                         "loop_mufu": loop["ops"].get("MUFU", 0)}
        rows[(threads, targets)] = row

    eps = cs.TREE["eps"]
    prep1, g1 = primed_inputs(dev, 1_000_000, cs)
    x1 = cs.tree_inputs(prep1, g1)
    dense = (x1["targets"], x1["summaries"])
    prep3, g3 = primed_inputs(dev, 4_000_000, cs)
    x3 = cs.far3_inputs(prep3, g3)
    idx2 = prep3["idx2"]
    masked = (x3["targets"], x3["supers"], idx2)
    g2 = x3["supers"].shape[1]
    kept = g2 * g2 - int((idx2 < g2).sum())
    pairs = {"quad_dense": float(dense[0].shape[0]) * dense[1].shape[1],
             "quad_masked": float(masked[0].shape[0] // g2) * kept}
    calls = {"quad_dense": lambda: cuda_tree.acc_cross_quad(*dense, eps=eps),
             "quad_masked": lambda: cuda_tree.acc_cross_quad_masked(
                 *masked, eps=eps)}
    first = {}
    order = layouts + layouts[::-1]
    for layout in order:
        _build._libs["tree"] = ctypes.CDLL(built[layout][0])
        row = rows[layout]
        for name, call in calls.items():
            got = call()
            want = first.setdefault(name, got)
            if not torch.equal(got, want):
                raise SystemExit(f"quad_layouts: {name} at {layout} differs "
                                 "from the first layout's bits")
            row[name].setdefault("ms", []).append(cs.cuda_ms(call, 10))
            row[name].update(cs.issue_fields(
                {name: row[name]["loop_instructions"]}, name, pairs[name],
                card))
    masks = {"keep_mask_ms": cs.cuda_ms(
                 lambda: cuda_tree._keep_mask(idx2, g2), 20),
             "kept_list_ms": cs.cuda_ms(lambda: kept_lists(idx2, g2), 20)}
    for layout in layouts:
        print(json.dumps(rows[layout]), flush=True)
    summary = {"shapes": {"quad_dense": [dense[0].shape[0],
                                         dense[1].shape[1]],
                          "quad_masked": [masked[0].shape[0], g2, kept]},
               "pairs": pairs, "eps": eps, **masks,
               "nvidia_smi": card["smi"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
