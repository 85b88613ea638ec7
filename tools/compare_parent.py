#!/usr/bin/env python3
"""Time two trees of the port on one card, in turns: the paths that launch
`pairs_quad_shared` and `pairs_short_hybrid`, each turn in a process of its
own that imports `chip_smoke` and `spacetpu_torch` from its tree.

    git archive <parent> | tar -x -C .archive/parent
    python3 tools/compare_parent.py --other .archive/parent

Turns run other, this, this, other. Each builds its tree's kernels and
drives, through `chip_smoke`'s phases, far3-4M (`far3_path`), the Plummer
sphere of 1M bodies (`plummer_path`, three far levels) and treepm-1M with
pallas_method="mxu" (`mxu_paths/treepm`), and prints one JSON line: ms a
step, the force error against the direct kernel, `pairs_quad_shared`'s
time a force pass (`kernel_ms`, M1 + M2) and `pairs_short_hybrid`'s
(`short_ms`), each by CUDA events. The last line gathers the turns beside
the card's name and power limit. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys of each phase's line a turn keeps
KEEP = ("ms_per_step", "force_rel_err_median", "force_rel_err_p99",
        "kernel_ms", "short_ms", "pm_ms", "prep_ms", "eval_ms",
        "launches_per_pass")


def turn(root: str) -> dict:
    """One turn in this process: the phases of the tree at `root`."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.phase_device(dev, False)
    cs.phase_build(False)
    cs.phase_far3_path(dev, False, card)
    cs.phase_plummer_path(dev, False, card)
    cs.phase_treepm_path(dev, False, card, method="mxu",
                         phase="mxu_paths/treepm", steps=3)
    return {"root": root, "smi": card["smi"], **{
        phase: {k: cs.RESULTS[phase].get(k) for k in KEEP}
        for phase in ("far3_path", "plummer_path", "mxu_paths/treepm")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (the parent commit)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn))), flush=True)
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
             "--turn", root], cwd=root, capture_output=True, text=True,
            timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"compare_parent: the {label} turn failed "
                             f"(exit {proc.returncode})")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["tree"] = label
        print(json.dumps(row), flush=True)
        turns.append(row)
    print(json.dumps({"turns": [t["tree"] for t in turns],
                      "nvidia_smi": turns[0]["smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
