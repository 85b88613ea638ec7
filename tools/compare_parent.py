#!/usr/bin/env python3
"""Time two trees of the port on one card, in turns: the paths that launch
the redesigned tree kernels, each turn in a process of its own that imports
`chip_smoke` and `spacetpu_torch` from its tree.

    git archive <parent> | tar -x -C .archive/parent
    python3 tools/compare_parent.py --other .archive/parent
    python3 tools/compare_parent.py --other .archive/parent \\
        --phases strip_path,far3_strip_path,mxu_paths/tree

Turns run other, this, this, other. Each builds its tree's kernels and
drives, through `chip_smoke`'s phases, the paths named by `--phases` (all
by default): far3-4M (`far3_path`: `pairs_quad_shared`), the Plummer
sphere of 1M bodies (`plummer_path`), treepm-1M with pallas_method="mxu"
(`mxu_paths/treepm`: `pairs_short_hybrid`), strip-1M (`strip_path`) and
far3-strip-4M (`far3_strip_path`: `near_strip`) and tree-1M with
pallas_method="mxu" (`mxu_paths/tree`: `pairs_hybrid`), and the app at
1M bodies (`app_path`: PM and `splat_tiles`, host-bound). It prints one
JSON line: ms a step, the force error against the direct kernel, each
kernel's time a force pass by CUDA events (`kernel_ms`; `short_ms` for
TreePM's short-range pass; the app's frames/s, ticks/s, PNG ms and render
pieces), and for the three tree paths a digest of `near_strip`'s or
`pairs_hybrid`'s float32 output on the path's final state (`bits`: the
tree paths are deterministic, so equal digests in every turn mean the
same bits); `kernel_bits` digests both kernels' outputs on 192 seeded
inputs (`bit_cases`). The last line gathers the turns, the outputs whose
bits are the same in every turn (`same_bits`), and the card's name and
power limit. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys of each phase's line a turn keeps
KEEP = ("ms_per_step", "force_rel_err_median", "force_rel_err_p99",
        "kernel_ms", "short_ms", "pm_ms", "prep_ms", "eval_ms",
        "launches_per_pass", "frames_per_s", "ticks_per_s", "png_ms_median",
        "render_ms")

PHASES = ("far3_path", "plummer_path", "mxu_paths/treepm", "strip_path",
          "far3_strip_path", "mxu_paths/tree", "app_path", "kernel_bits")

#: the phases whose turn carries digests of kernel outputs (`bits`)
BIT_PHASES = ("strip_path", "far3_strip_path", "mxu_paths/tree",
              "kernel_bits")


def digest(x) -> str:
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest(
        )[:16]


def bit_cases(cs, dev):
    """(case, output) of `near_strip` and `pairs_hybrid` on seeded inputs of
    the card tests' sizes: strip preps and TreePM cutoff lists at leaf 15,
    31, 100 (strip) or 127 (the lists take a leaf + 1 that divides 2048) and
    255, both dtypes, each law unsoftened and softened, plummer at an eps
    whose float32 square is subnormal, both pseudo-bodies."""
    import torch

    from spacetpu_torch.ops import cuda_tree
    from spacetpu_torch.ops import tree as tree_ops

    pair_hold = cs.load_tests_module("pair_hold")
    laws = (("plummer", 1e-3), ("plummer", 1e-2), ("plummer", 0.0),
            ("ref", 1e-2), ("ref", 0.0), ("plummer", 1e-20))
    dtypes = (torch.float32, torch.float64)
    for n, leaf in ((2003, 15), (4099, 31), (6007, 100), (20011, 255)):
        pos, mass = cs.bodies(n, seed=n, dtype=torch.float64, dev=dev)
        gg = -(-n // leaf)
        prep = tree_ops.tree_prep(pos, mass, theta=0.5, gg=gg, leaf=leaf,
                                  near_mode="strip",
                                  k_near=tree_ops.default_k_near(0.5, gg))
        for dtype in dtypes:
            pool = [prep[k].to(dtype) for k in ("pos_g", "mass_g", "com",
                                                 "m_tot")]
            for (law, eps), pseudo in ((x, y) for x in laws
                                       for y in (False, True)):
                yield (f"near_strip/{leaf}/{dtype}/{law}/{eps}/{pseudo}",
                       cuda_tree.near_strip(
                           pool[0], prep["idx"], *pool, softening=law,
                           eps=eps, g=1.0, monopole_pseudo=pseudo))
    for n, leaf in ((2003, 15), (4099, 31), (6007, 127), (20011, 255)):
        for dtype in dtypes:
            prep, rows = pair_hold.short_inputs(n, leaf, 0.35, dtype, dev)
            for (law, eps), pseudo in ((x, y) for x in laws
                                       for y in (False, True)):
                yield (f"pairs_hybrid/{leaf}/{dtype}/{law}/{eps}/{pseudo}",
                       cuda_tree.near_pairs_hybrid(
                           prep["pos_g"], rows[pseudo], prep["near_flat"],
                           prep["near_tile_tgt"], softening=law, eps=eps))


def turn(root: str, phases) -> dict:
    """One turn in this process: the phases of the tree at `root`."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import cuda_tree

    dev = torch.device("cuda")
    card = cs.phase_device(dev, False)
    cs.phase_build(False)
    eps = cs.TREE["eps"]
    emitted = {}
    emit = cs.emit

    def keep(obj):
        if "phase" in obj:
            emitted.setdefault(obj["phase"], obj)
        emit(obj)

    cs.emit = keep

    def near_strip_bits(run):
        prep, g, _ = run
        return digest(cuda_tree.near_strip(
            *cs.strip_inputs(prep, g)["near"], softening="plummer", eps=eps,
            g=g, monopole_pseudo=False))

    def mxu_tree():
        prep, g, launches = cs.drive_tree(
            "mxu_paths/tree", presets.fixed_cloud(1_000_000), dev, False,
            card, sim_kw=dict(cs.TREE, pallas_method="mxu"), steps=3,
            per_pass=cs.FAR2_MXU_PASS, far_levels=2, cluster_mode="equal")
        return digest(cuda_tree.near_pairs_hybrid(
            prep["pos_g"], cs.tree_inputs(prep, g)["srows"][False],
            prep["near_flat"], prep["near_tile_tgt"], softening="plummer",
            eps=eps))

    drive = {
        "far3_path": lambda: cs.phase_far3_path(dev, False, card),
        "plummer_path": lambda: cs.phase_plummer_path(dev, False, card),
        "mxu_paths/treepm": lambda: cs.phase_treepm_path(
            dev, False, card, method="mxu", phase="mxu_paths/treepm",
            steps=3),
        "strip_path": lambda: near_strip_bits(
            cs.phase_strip_path(dev, False, card)),
        "far3_strip_path": lambda: near_strip_bits(
            cs.phase_far3_strip_path(dev, False, card)),
        "mxu_paths/tree": mxu_tree,
        "app_path": lambda: cs.phase_app_path(dev, False, card),
        "kernel_bits": lambda: {case: digest(x)
                                for case, x in bit_cases(cs, dev)}}
    out = {"root": root, "smi": card["smi"]}
    for phase in phases:
        bits = drive[phase]()
        row = (cs.RESULTS.get(phase) or emitted.get(phase)
               if phase != "kernel_bits" else {})
        out[phase] = {k: row[k] for k in KEEP if k in row}
        if phase in BIT_PHASES:
            out[phase]["bits"] = bits
    return out


def same_bits(turns, phase) -> list:
    """[outputs whose digest is the same in every turn, outputs]."""
    bits = [t[phase]["bits"] for t in turns]
    if isinstance(bits[0], str):
        return [int(len(set(bits)) == 1), 1]
    return [sum(len({b[case] for b in bits}) == 1 for case in bits[0]),
            len(bits[0])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (the parent commit)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases of a turn, of: "
                         + ", ".join(PHASES))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn), phases)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("compare_parent: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    turns = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--other", other,
             "--phases", args.phases, "--turn", root], cwd=root,
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"compare_parent: the {label} turn failed "
                             f"(exit {proc.returncode})")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["tree"] = label
        print(json.dumps(row), flush=True)
        turns.append(row)
    print(json.dumps({"turns": [t["tree"] for t in turns],
                      "same_bits": {p: same_bits(turns, p) for p in phases
                                    if p in BIT_PHASES},
                      "nvidia_smi": turns[0]["smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
