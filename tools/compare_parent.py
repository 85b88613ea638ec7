#!/usr/bin/env python3
"""Time two trees of the port on one card, in turns: the paths that launch
the redesigned kernels, each turn in a process of its own that imports
`chip_smoke` and `spacetpu_torch` from its tree.

    git archive <parent> | tar -x -C .archive/parent
    python3 tools/compare_parent.py --other .archive/parent
    python3 tools/compare_parent.py --other .archive/parent \\
        --phases main_path,tree_path,kernel_bits

Turns run other, this, this, other. Each builds its tree's kernels and drives,
through `chip_smoke`'s phases, the paths named by `--phases` (all by default):
the main path (`main_path`: `bench.py`'s configuration, 262,144 bodies, prime +
11 steps of `direct_vpu`), tree-1M (`tree_path`), far3-4M (`far3_path`), the
Plummer sphere of 1M bodies (`plummer_path`) (the three launch `pairs_direct`;
far3 also `pairs_quad_shared`), treepm-1M with pallas_method="mxu"
(`mxu_paths/treepm`: `pairs_short_hybrid`), strip-1M (`strip_path`) and
far3-strip-4M (`far3_strip_path`: `near_strip`), tree-1M with
pallas_method="mxu" (`mxu_paths/tree`: `pairs_hybrid`), and the app at 1M
bodies (`app_path`: PM and `splat_tiles`, host-bound). tree-1M, strip-1M and
tree-1M-mxu launch `quad_dense`; far3-4M, far3-strip-4M and the Plummer sphere
`quad_masked`; the headless command line at 1M bodies (`headless_path`: 20
steps between two energy sums, each one `pair_potential` call) its wall
seconds, the two sums' seconds and the printed energy drift. It prints one
JSON line a turn: ms a step, the force error
against the direct kernel, each kernel's time a force pass by CUDA events
(`kernel_ms`; `short_ms` for TreePM's short-range pass; the app's frames/s,
ticks/s, PNG ms and render pieces), and digests (`bits`) of float32 outputs on
each path's final state: the main path's positions and forces, the pair-list
tree paths' positions and `pairs_direct` output, `near_strip`'s or
`pairs_hybrid`'s. The paths are deterministic, so equal digests in every turn
mean the same bits. `kernel_bits` digests `direct_vpu`, `pairs_direct`,
`near_strip`, `pairs_hybrid`, `quad_dense` and `quad_masked` on seeded inputs
(`bit_cases`); a digest of an output that holds a NaN or an infinity is marked
`nonfinite:`. It also calls `pair_potential` twice on each of
`potential_calls`' inputs: a digest is marked `nondeterministic:` where the
two calls differ, and the last line holds each turn's sums to those of the
first other turn, body by body (`potential`: 1e-5 of the sum in float32,
1e-12 in float64). The last line gathers the turns, the outputs whose bits are
the same in every turn (`same_bits`), those that differ, and those that differ
where some turn's output is not finite (`differ`, `differ_nonfinite`), and the
card's name and power limit. Needs one CUDA card; exits 2 without
one.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys of each phase's line a turn keeps
KEEP = ("ms_per_step", "force_rel_err_median", "force_rel_err_p99",
        "kernel_ms", "short_ms", "pm_ms", "prep_ms", "eval_ms",
        "launches_per_pass", "frames_per_s", "ticks_per_s", "png_ms_median",
        "render_ms", "wall_s", "energy_sums_s")

PHASES = ("main_path", "tree_path", "far3_path", "plummer_path",
          "mxu_paths/treepm", "strip_path", "far3_strip_path",
          "mxu_paths/tree", "app_path", "headless_path", "kernel_bits")

#: the phases whose turn carries digests of kernel outputs (`bits`)
BIT_PHASES = ("main_path", "tree_path", "far3_path", "plummer_path",
              "strip_path", "far3_strip_path", "mxu_paths/tree",
              "headless_path", "kernel_bits")

#: `pair_potential`'s hold against the other tree's sums, body by body
#: relative to the sum (chip_smoke.POTENTIAL_TOL)
POTENTIAL_TOL = {"float32": 1e-5, "float64": 1e-12}


def digest(x) -> str:
    import torch

    h = hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest(
        )[:16]
    return h if bool(torch.isfinite(x).all()) else f"nonfinite:{h}"


def bit_cases(cs, dev):
    """(case, output) of `direct_vpu`, `pairs_direct`, `near_strip`,
    `pairs_hybrid`, `quad_dense` and `quad_masked` on seeded inputs of the card
    tests' sizes, both dtypes, each law unsoftened and softened, plummer at an
    eps whose float32 square is subnormal: `direct_vpu` on M targets and K
    sources, M not a multiple of a block's targets and K not of the 256-source
    tile (the targets the sources where M = K); strip preps and TreePM cutoff
    lists at leaf 15, 31, 100 (strip) or 127 (the lists take a leaf + 1 that
    divides 2048) and 255, both pseudo-bodies; the quadrupole kernels on
    `pair_hold`'s ragged cases (`quad_dense_case`, `quad_masked_case`) at eps
    1e-2 and 0."""
    import torch

    from spacetpu_torch.ops import cuda_direct, cuda_tree
    from spacetpu_torch.ops import tree as tree_ops

    # this tree's tests/pair_hold.py, so that every turn gets the same
    # inputs, whichever tree it runs
    spec = importlib.util.spec_from_file_location(
        "pair_hold", os.path.join(HERE, "tests", "pair_hold.py"))
    pair_hold = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pair_hold)
    laws = (("plummer", 1e-3), ("plummer", 1e-2), ("plummer", 0.0),
            ("ref", 1e-2), ("ref", 0.0), ("plummer", 1e-20))
    dtypes = (torch.float32, torch.float64)
    for m, k in ((100, 100), (333, 1001), (4099, 4099), (20011, 20011)):
        for dtype in dtypes:
            pos_j, mass_j = cs.bodies(k, seed=k, dtype=dtype, dev=dev)
            pos_i = pos_j if m == k else cs.bodies(m, seed=m + 1,
                                                   dtype=dtype, dev=dev)[0]
            for law, eps in laws:
                yield (f"direct_vpu/{m}/{k}/{dtype}/{law}/{eps}",
                       cuda_direct.acc_cross_kernel(
                           pos_i, pos_j, mass_j, softening=law, eps=eps,
                           g=1.0))
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
                args = (prep["pos_g"], rows[pseudo], prep["near_flat"],
                        prep["near_tile_tgt"])
                for name in ("pairs_direct", "pairs_hybrid"):
                    yield (f"{name}/{leaf}/{dtype}/{law}/{eps}/{pseudo}",
                           getattr(cuda_tree, f"near_{name}")(
                               *args, softening=law, eps=eps))
    for dtype in dtypes:
        for eps in (1e-2, 0.0):
            for m, s in pair_hold.QUAD_SIZES:
                tgt, summ = pair_hold.quad_dense_case(m, s, eps, dtype, dev)
                yield (f"quad_dense/{m}/{s}/{dtype}/{eps}",
                       cuda_tree.acc_cross_quad(tgt, summ, eps=eps))
            yield (f"quad_masked/wide/{dtype}/{eps}",
                   cuda_tree.acc_cross_quad_masked(
                       *pair_hold.quad_masked_case(eps, dtype, dev), eps=eps))


def potential_calls(cs, dev):
    """(case, first call, second call) of `pair_potential` on seeded inputs:
    both dtypes and laws, eps 1e-2 and 0, N = 4099 and 20011 (several
    blocks, neither a multiple of a block's rows), and the headless path's
    scene at N = 100,001 in float32 at eps = 0."""
    import torch

    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import energy

    inputs = [(f"{n}/{dtype}", *cs.bodies(n, seed=n, dtype=dtype, dev=dev))
              for n in (4099, 20011)
              for dtype in (torch.float32, torch.float64)]
    state = presets.fixed_cloud(100_000).state(dtype=torch.float32,
                                               device=dev)
    for name, pos, mass in inputs:
        for law, eps in (("plummer", 1e-2), ("plummer", 0.0), ("ref", 0.0)):
            kw = dict(softening=law, eps=eps)
            yield (f"pair_potential/{name}/{law}/{eps}",
                   energy.pair_potential(pos, mass, **kw),
                   energy.pair_potential(pos, mass, **kw))
    yield ("pair_potential/fixed_cloud/100000",
           energy.pair_potential(state.pos, state.mass, eps=0.0),
           energy.pair_potential(state.pos, state.mass, eps=0.0))


def turn(root: str, phases, save: str | None = None) -> dict:
    """One turn in this process: the phases of the tree at `root`; the
    `pair_potential` sums of `kernel_bits` go to the file `save`."""
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

    def pairs_direct_bits(run, eps):
        prep, g, _ = run
        return {"positions": digest(prep["pos_g"]),
                "pairs_direct": digest(cuda_tree.near_pairs_direct(
                    prep["pos_g"], cs.tree_inputs(prep, g)["srows"][False],
                    prep["near_flat"], prep["near_tile_tgt"],
                    softening="plummer", eps=eps))}

    def main_path():
        """chip_smoke's main path, direct_vpu (`run_main_path`: prime, a
        step, ten timed steps, then the force pass timed alone)."""
        _, state = cs.run_main_path(
            presets.random_cluster(262_144, seed=0, g=1.0), "vpu", dev,
            False, card)
        return {"positions": digest(state.pos), "forces": digest(state.acc)}

    def mxu_tree():
        prep, g, launches = cs.drive_tree(
            "mxu_paths/tree", presets.fixed_cloud(1_000_000), dev, False,
            card, sim_kw=dict(cs.TREE, pallas_method="mxu"), steps=3,
            per_pass=cs.FAR2_MXU_PASS, far_levels=2, cluster_mode="equal")
        return digest(cuda_tree.near_pairs_hybrid(
            prep["pos_g"], cs.tree_inputs(prep, g)["srows"][False],
            prep["near_flat"], prep["near_tile_tgt"], softening="plummer",
            eps=eps))

    def headless():
        state, _ = cs.phase_headless_path(dev, False, card)
        return {"positions": digest(state.pos)}

    def kernel_bits():
        import torch

        bits = {case: digest(x) for case, x in bit_cases(cs, dev)}
        sums = {}
        for case, first, second in potential_calls(cs, dev):
            bits[case] = (digest(first) if torch.equal(first, second)
                          else f"nondeterministic:{digest(first)}")
            sums[case] = first.cpu()
        if save:
            torch.save(sums, save)
        return bits

    drive = {
        "main_path": main_path,
        "tree_path": lambda: pairs_direct_bits(
            cs.phase_tree_path(dev, False, card), eps),
        "far3_path": lambda: pairs_direct_bits(
            cs.phase_far3_path(dev, False, card), eps),
        "plummer_path": lambda: pairs_direct_bits(
            cs.phase_plummer_path(dev, False, card), 1e-2),
        "mxu_paths/treepm": lambda: cs.phase_treepm_path(
            dev, False, card, method="mxu", phase="mxu_paths/treepm",
            steps=3),
        "strip_path": lambda: near_strip_bits(
            cs.phase_strip_path(dev, False, card)),
        "far3_strip_path": lambda: near_strip_bits(
            cs.phase_far3_strip_path(dev, False, card)),
        "mxu_paths/tree": mxu_tree,
        "app_path": lambda: cs.phase_app_path(dev, False, card),
        "headless_path": headless,
        "kernel_bits": kernel_bits}
    out = {"root": root, "smi": card["smi"]}
    for phase in phases:
        bits = drive[phase]()
        row = (cs.RESULTS.get(phase) or emitted.get(phase)
               if phase != "kernel_bits" else {})
        out[phase] = {k: row[k] for k in KEEP if k in row}
        if phase == "headless_path":
            out[phase]["energy_drift"] = [
                float(ln.split(":")[1].split()[0]) for ln in row["printed"]
                if "energy drift" in ln]
        if phase in BIT_PHASES:
            out[phase]["bits"] = bits
    return out


def same_bits(turns, phase) -> dict:
    """The outputs of a phase whose digest is the same in every turn
    (`same`, of `outputs`), and the names of those that differ, where every
    turn's output is finite (`differ`) and where some turn's is not
    (`differ_nonfinite`)."""
    bits = [t[phase]["bits"] for t in turns]
    if isinstance(bits[0], str):
        bits = [{phase: b} for b in bits]
    out = {"same": 0, "outputs": len(bits[0]), "differ": [],
           "differ_nonfinite": []}
    for case in bits[0]:
        got = {b[case] for b in bits}
        if len(got) == 1:
            out["same"] += 1
        elif any(d.startswith("nonfinite:") for d in got):
            out["differ_nonfinite"].append(case)
        else:
            out["differ"].append(case)
    return out


def potential_hold(files, labels) -> dict:
    """Each turn's `pair_potential` sums against the first other turn's,
    body by body relative to the sum: the largest a dtype, and whether every
    case is within `POTENTIAL_TOL`."""
    import torch

    sums = [torch.load(f) for f in files]
    ref = sums[labels.index("other")]
    worst = {}
    for turn_sums in sums:
        for case, got in turn_sums.items():
            want = ref[case].double()
            rel = float(((got.double() - want).abs() / want.abs()).max())
            key = str(got.dtype)[6:]
            worst[key] = max(worst.get(key, 0.0), rel)
    return {"max_rel_to_other": worst,
            "held": all(v <= POTENTIAL_TOL[k] for k, v in worst.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (the parent commit)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases of a turn, of: "
                         + ", ".join(PHASES))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn), phases,
                              args.save)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("compare_parent: no CUDA device", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    turns = []
    scratch = tempfile.TemporaryDirectory()
    labels = ("other", "this", "this", "other")
    files = [os.path.join(scratch.name, f"potential{k}.pt")
             for k in range(len(labels))]
    for label, root, save in zip(labels, (other, HERE, HERE, other), files):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--other", other,
             "--phases", args.phases, "--turn", root, "--save", save],
            cwd=root, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"compare_parent: the {label} turn failed "
                             f"(exit {proc.returncode})")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["tree"] = label
        print(json.dumps(row), flush=True)
        turns.append(row)
    last = {"turns": [t["tree"] for t in turns],
            "same_bits": {p: same_bits(turns, p) for p in phases
                          if p in BIT_PHASES},
            "nvidia_smi": turns[0]["smi"]}
    if "kernel_bits" in phases:
        last["potential"] = potential_hold(files, labels)
    scratch.cleanup()
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
