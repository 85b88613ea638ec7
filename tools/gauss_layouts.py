#!/usr/bin/env python3
"""Time layouts of `pairs_short`'s gauss walk on one card, beside other trees.

    python3 tools/gauss_layouts.py [--layouts 32x32,4x32,...]
        [--other NAME=DIR ...] [--n 1000000]

The walk of csrc/tree.cu (`pairs_cut_kernel`) takes one target a thread and
chunks of 32 staged sources (CUT_CHUNK: a warp's lanes box one chunk, the
unit a warp skips). A layout UNROLLxKB sets the sources a trip of a chunk's
sweep (the `#pragma unroll` of its pair loop; 32, the chunk whole, as the
tree stands) and the staged sources a stage in KB (CUT_STAGE_BYTES; 32 as
the tree stands). For each layout the script builds a copy of csrc/ with
those set, and for each `--other` tree its csrc/ as it stands (nvcc, one
process a library, all started together); reports ptxas' registers and
spills and the pair loop's SASS (`chip_smoke.sass_loops`) of the float32
instance each mode runs; and times, by CUDA events, the C entry
`spacetpu_pairs_short` on the lists of treepm-gauss-1M
(`make_simulation(algorithm="treepm", pm_split="gauss")` on
fixed_cloud(N), float32, primed and stepped once; the prep of its state):
at its plummer eps 0 (`walk`: GaussLean, which skips the chunks beyond u =
3.5) and at eps 1e-3 (`sweep`: ShortWeight, no exact zero, every chunk
swept), in two rounds (in order, then reversed). Each output is held
against the plain version and against the first build's (the largest
difference over max|a|, and whether the bits are the same). One JSON line a
build, then a line with the pair counts, the card's name and power limit.
Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

#: the float32 instance each mode runs, in the trees this script meets
#: (the walk since it was written; the parent's one-target `pairs_kernel`),
#: and the pairs a trip of its pair loop where the build does not say
TAGS = {"walk": (("pairs_cut_kernelIfNS_9GaussLeanIfEELb0E", 32),
                 ("pairs_kernelIfNS_11ShortWeightIfLi0ELi1EEELb0E", 8)),
        "sweep": (("pairs_cut_kernelIfNS_11ShortWeightIfLi0ELi1EEELb0E", 32),
                  ("pairs_kernelIfNS_11ShortWeightIfLi0ELi1EEELb0E", 8))}
UNROLL = ("#pragma unroll\n    for (int jj = 0; jj < CUT_CHUNK; ++jj) {")


def build(layouts, others, root: pathlib.Path) -> dict:
    """A library a layout and one a tree of `others` ({name: root}):
    {key: (path, nvcc log)}."""
    from spacetpu_torch import _build

    jobs = {}
    for key in list(layouts) + list(others):
        csrc = (pathlib.Path(others[key]) / "spacetpu_torch" / "csrc"
                if key in others else _build.CSRC)
        text = (csrc / "tree.cu").read_text()
        if key not in others:
            unroll, kb = (int(v) for v in key.split("x"))
            text, k = re.subn(r"constexpr int CUT_STAGE_BYTES = [0-9 *]+;",
                              f"constexpr int CUT_STAGE_BYTES = {kb * 1024};",
                              text)
            k2 = text.count(UNROLL)
            text = text.replace(UNROLL, UNROLL.replace(
                "unroll", f"unroll {unroll}", 1))
            if (k, k2) != (1, 1):
                raise SystemExit("gauss_layouts: tree.cu has no single "
                                 "CUT_STAGE_BYTES and walk pair loop")
        d = root / key
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "tree.cu").write_text(text)
        out = d / "libtree.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(out), str(d / "tree.cu")]
        jobs[key] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for key, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"gauss_layouts: nvcc failed for {key}:\n{log}")
        built[key] = (out, log)
    return built


def path_lists(n, dev):
    """treepm-gauss-1M's lists: (args of near_pairs_short, its kw)."""
    import torch

    import spacetpu_torch as st
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import tree as tree_ops
    from spacetpu_torch.ops import treepm as treepm_ops

    scene = presets.fixed_cloud(n)
    sim = st.make_simulation(scene.n, g=scene.g, device=dev,
                             algorithm="treepm", pm_split="gauss")
    state = sim.step(sim.prime(scene.state(dtype=torch.float32,
                                           device=dev)), 1e-3)
    mp, cfg = sim.mesh_params, sim.config
    prep = treepm_ops.treepm_prep(
        state.pos, state.mass, rcut=mp["rcut"], k_near=sim.caps["k_near"],
        gg=sim.caps["gg"], leaf=cfg.resolved_leaf(),
        near_tiles=sim.caps["near_tiles"])
    srows = tree_ops._pack_augmented(prep["pos_g"], prep["mass_g"],
                                     prep["com"], prep["m_tot"],
                                     float(cfg.g), monopole_pseudo=False)
    args = (prep["pos_g"], srows, prep["near_flat"], prep["near_tile_tgt"])
    kw = dict(softening=cfg.softening, eps=cfg.resolved_eps(), rs=mp["rs"],
              rcut=mp["rcut"], split=mp["split"])
    return args, kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="32x32,4x32,8x32,16x32,32x16,32x64")
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR", help="another tree (its csrc/)")
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from spacetpu_torch.ops import cuda_tree

    if not torch.cuda.is_available():
        print("gauss_layouts: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.phase_device(dev, False)
    layouts = args.layouts.split(",")
    others = dict(o.split("=", 1) for o in args.other)
    built = build(layouts, others, HERE / ".archive" / "gauss_layouts")
    cuobjdump = str(pathlib.Path(__import__(
        "spacetpu_torch._build", fromlist=["nvcc"]).nvcc()).parent
        / "cuobjdump")
    (pos_g, srows, flat, tgt), kw = path_lists(args.n, dev)
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    starts = cuda_tree.tile_starts(tgt, gg)
    pj = flat.numel() // tgt.numel()
    n_src = srows.shape[1] // block - 1
    settings = {"walk": kw, "sweep": dict(kw, eps=1e-3)}
    plain = {k: cuda_tree.near_pairs_short_plain(pos_g, srows, flat, tgt,
                                                 **v)
             for k, v in settings.items()}
    P = ctypes.c_void_p
    calls = {}
    for key, (path, _) in built.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.spacetpu_pairs_short
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P,
                       ctypes.c_longlong, P, P, P, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_double, ctypes.c_double, ctypes.c_double, P]
        fn.restype = ctypes.c_int
        for mode, s in settings.items():
            out = torch.empty_like(pos_g)

            def call(fn=fn, out=out, s=s, key=key):
                rc = fn(0, 0, 1, pos_g.data_ptr(), srows.data_ptr(),
                        srows.stride(0), flat.data_ptr(), starts.data_ptr(),
                        out.data_ptr(), gg, leaf, pj, n_src, float(s["eps"]),
                        float(s["rs"]), float(s["rcut"]),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise SystemExit(f"gauss_layouts: {key}: CUDA error {rc}")
                return out

            calls[key, mode] = call
    keys = list(built)
    first, times = {}, {k: [] for k in calls}
    for order in (keys, keys[::-1]):
        for key in order:
            for mode in settings:
                got = calls[key, mode]()
                torch.cuda.synchronize()
                first.setdefault((key, mode), got.clone())
                times[key, mode].append(cs.cuda_ms(calls[key, mode], 3))
    counts = {}
    stage = cuda_tree.CUT_STAGE_BYTES
    for kb in sorted({int(k.split("x")[1]) for k in layouts} | {stage // 1024}):
        cuda_tree.CUT_STAGE_BYTES = kb * 1024
        counts[kb] = {m: cuda_tree.short_pair_counts(pos_g, srows, flat, tgt,
                                                     **s)
                      for m, s in settings.items()}
    cuda_tree.CUT_STAGE_BYTES = stage
    for key in keys:
        path, log = built[key]
        row = {"build": key}
        for mode in settings:
            tags = TAGS[mode]
            if key not in others:
                unroll, kb = (int(v) for v in key.split("x"))
                tags = ((tags[0][0], unroll),)
            else:
                kb = stage // 1024
            found = loop = None
            for tag, trip in tags:
                found = [k for k in cs.ptxas_summary(log)
                         if tag in k["function"]]
                if found:
                    break
            if found:
                # the pair loop holds a MUFU a pair or more
                cs.MAIN_INSTANCES["pairs_short_gauss"] = tag
                cs.LOOP_MUFU["pairs_short_gauss"] = min(trip, 8)
                loop = next((v for f, v in cs.sass_loops(
                    cuobjdump, str(path)).items() if tag in f and v), None)
            per_pair = loop["instructions"] / trip if loop else None
            pairs = counts[kb][mode]["listed" if tag.startswith(
                "pairs_kernel") else "evaluated"]
            got, want = first[key, mode], plain[mode]
            ref = first[keys[0], mode]
            row[mode] = {
                "instance": tag if found else None,
                "registers": found[0]["registers"] if found else None,
                "spill_stores": found[0].get("spill_stores") if found
                else None,
                "loop": loop, "sass_per_pair": per_pair,
                "ms": times[key, mode],
                "max_rel_err": float((got - want).abs().max()
                                     / want.abs().max()),
                "same_bits_as_first": bool(torch.equal(got, ref)),
                "max_diff_from_first": float((got - ref).abs().max()
                                             / ref.abs().max()),
                "issue_bound_ms": None if per_pair is None else
                1e3 * per_pair * pairs / (card["sm_count"] * 4 * 32
                                          * card["max_sm_mhz"] * 1e6)}
        print(json.dumps(row), flush=True)
    print(json.dumps({"n": args.n, "shape": [gg, leaf, pj],
                      "settings": settings, "pairs_by_stage_kb": counts,
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
