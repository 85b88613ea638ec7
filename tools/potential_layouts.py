#!/usr/bin/env python3
"""Time the geometries and rsqrt modes of `pair_potential` on one card at
headless-1M's state.

    python3 tools/potential_layouts.py [--layouts 16x16x4,16x8x4,8x8x4] \\
        [--slots 8,16,32] [--modes checked,guarded] [--eps 0,1e-2]

The band kernel of csrc/direct.cu (`potential_band_kernel`) takes three
constants: POT_P (rows a lane holds), POT_WARPS (warps a block) and
POT_UNROLL (columns a trip of its column loop), a layout PxWARPSxUNROLL.
For each layout the script builds a copy of csrc/ with those set, and for
each of `--modes` a copy at the source's own layout whose float32 band
kernels all take that mode (POT_<MODE>: how a pair's 1 / d is taken), all
with nvcc, one process a library, started together. It reports ptxas'
registers and spills and the pair loop's SASS (`chip_smoke.sass_loops`)
of the float32 band kernel each row runs. It then times, by CUDA events,
through the port's own wrapper (`energy.pair_potential`) on the bodies of
`fixed_cloud(1_000_000)` (N = 1,000,001, float32, plummer: the headless
command line's first energy sum), in two rounds (in order, then
reversed): each layout at eps = 0 with `energy.POTENTIAL_SLOTS` set to
each of `--slots`, and each mode at each of `--eps`. Every call must
give the bits of the first call of its row; every layout's sums must lie
within 1e-5 of the first layout's, body by body, and every mode's sums at
one eps must be the first mode's bits.
One JSON line a layout, one a mode, then a summary line with the card's
name and power limit and the SM clock and power draw that `nvidia-smi`
read every 100 ms while the kernels ran (min, median, max). Needs one
CUDA card; exits 2 without one.
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

#: the float32 dispatch of `launch_potential`, whose modes a mode's copy
#: replaces
_DISPATCH = re.compile(r"(if constexpr \(std::is_same_v<T, float>\) \{\n"
                       r"    band = )(.*?)(;\n  \} else)", re.S)


def _copy(root: pathlib.Path, key: str, text: str) -> tuple:
    from spacetpu_torch import _build

    d = root / key
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    (d / "direct.cu").write_text(text)
    return d / "direct.so", d / "direct.cu"


def build(layouts, modes, root: pathlib.Path) -> dict:
    """A library of csrc/direct.cu for each (P, WARPS, UNROLL) and each
    mode ("mode:<name>"), built in parallel: {key: (path, nvcc's log)}."""
    from spacetpu_torch import _build

    src = (_build.CSRC / "direct.cu").read_text()
    jobs = {}
    for layout in layouts:
        text = src
        for name, value in zip(("POT_P", "POT_WARPS", "POT_UNROLL"), layout):
            text, k = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            if k != 1:
                raise SystemExit(f"potential_layouts: direct.cu has no "
                                 f"{name} constant")
        jobs[layout] = _copy(root, "x".join(map(str, layout)), text)
    for mode in modes:
        const = f"POT_{mode.upper()}"
        if not re.search(rf"constexpr int {const} = \d+;", src):
            raise SystemExit(f"potential_layouts: direct.cu has no {const}")
        text, k = _DISPATCH.subn(
            lambda m: m.group(1) + re.sub(r"POT_[A-Z]+", const, m.group(2))
            + m.group(3), src)
        if k != 1:
            raise SystemExit("potential_layouts: no float32 band dispatch "
                             "in direct.cu")
        jobs[f"mode:{mode}"] = _copy(root, f"mode_{mode}", text)
    procs = {key: (so, subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for key, (so, cu) in jobs.items()}
    out = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"potential_layouts: nvcc failed for {key}:\n"
                             + log)
        out[key] = (str(so), log)
    return out


def load(samples) -> dict:
    """min, median and max of the SM clock (MHz) and power draw (W) in
    `nvidia-smi`'s samples, with their count."""
    import statistics

    out = {"samples": len(samples)}
    for k, name in enumerate(("sm_mhz", "power_w")):
        vals = sorted(v[k] for v in samples)
        if vals:
            out[name] = [vals[0], statistics.median(vals), vals[-1]]
    return out


def rel_err(got, want) -> float:
    return float(((got.double() - want.double()).abs()
                  / want.double().abs()).max())


def sass_fields(cs, built, key, tag, per_loop, pairs, card) -> dict:
    """ptxas' registers and spills and the pair loop's SASS of the instance
    `tag` in the library `key`, with its issue bound over `pairs`."""
    from spacetpu_torch import _build

    so, log = built[key]
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    ptx = next(k for k in cs.ptxas_summary(log) if tag in k["function"])
    loop = next((v for f, v in cs.sass_loops(cuobjdump, so).items()
                 if tag in f), None)
    if not loop:
        return {"registers": ptx.get("registers"),
                "spill_stores": ptx.get("spill_stores", 0),
                "loop_instructions": None, "sass_per_pair": None}
    per_pair = loop["instructions"] / per_loop
    return {"registers": ptx.get("registers"),
            "spill_stores": ptx.get("spill_stores", 0),
            "loop_instructions": loop["instructions"],
            "loop_ops": loop["ops"], "sass_per_pair": per_pair,
            **cs.issue_fields({"pair_potential": per_pair
                               * cs.PAIRS_PER_LOOP["pair_potential"]},
                              "pair_potential", pairs, card)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts",
                    default="16x16x4,16x16x2,16x16x1,16x8x4,16x4x4,8x8x4,"
                            "12x4x4",
                    help="comma-separated PxWARPSxUNROLL (P a multiple of "
                         "WARPS)")
    ap.add_argument("--slots", default="8,16,32",
                    help="comma-separated band widths (POTENTIAL_SLOTS)")
    ap.add_argument("--modes", default="checked,guarded",
                    help="comma-separated float32 rsqrt modes of the band "
                         "kernel (POT_<MODE> of csrc/direct.cu)")
    ap.add_argument("--eps", default="0,1e-2",
                    help="comma-separated softening lengths of the modes")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("potential_layouts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spacetpu_torch import _build
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import energy

    layouts = [tuple(int(v) for v in s.split("x"))
               for s in args.layouts.split(",") if s]
    slot_list = [int(v) for v in args.slots.split(",")]
    modes = [m for m in args.modes.split(",") if m]
    eps_list = [float(v) for v in args.eps.split(",")]
    src = (_build.CSRC / "direct.cu").read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("POT_P", "POT_WARPS", "POT_UNROLL")}
    dev = torch.device("cuda")
    card = cs.phase_device(dev, False)
    built = build(layouts, modes, _build.BUILD_DIR / "potential_layouts")
    state = presets.fixed_cloud(1_000_000).state(dtype=torch.float32,
                                                 device=dev)
    pos, mass = state.pos, state.mass
    n = pos.shape[0]
    pairs = float(n) * (n - 1) / 2
    checked = int(re.search(r"constexpr int POT_CHECKED = (\d+);",
                            src).group(1))
    # sass_loops finds a band kernel's loop by its MUFU count a trip
    cs.MAIN_INSTANCES["pair_potential"] = "potential_band_kernelIf"
    rows = {}
    for layout in layouts:
        p, warps, unroll = layout
        cs.LOOP_MUFU["pair_potential"] = p * unroll
        tag = (f"potential_band_kernelIfLi{p}ELi{warps}ELi{checked}ELb0"
               f"EE")
        rows[layout] = {
            "layout": "x".join(map(str, layout)), "rows": 32 * p,
            "threads": 32 * warps, "eps": 0.0,
            **sass_fields(cs, built, layout, tag, p * unroll, pairs, card),
            "ms": {}}
    p, warps, unroll = const["POT_P"], const["POT_WARPS"], const["POT_UNROLL"]
    cs.LOOP_MUFU["pair_potential"] = p * unroll
    for mode in modes:
        value = int(re.search(rf"constexpr int POT_{mode.upper()} = (\d+);",
                              src).group(1))
        for eps in eps_list:
            tag = (f"potential_band_kernelIfLi{p}ELi{warps}ELi{value}ELb"
                   f"{int(eps != 0)}EE")
            rows[(mode, eps)] = {
                "mode": mode, "eps": eps,
                "layout": "x".join(map(str, (p, warps, unroll))),
                **sass_fields(cs, built, f"mode:{mode}", tag, p * unroll,
                              pairs, card),
                "ms": []}
    mode_rows = [k for k in rows if k not in layouts]

    first, bits, by_eps = None, {}, {}
    default_slots = energy.POTENTIAL_SLOTS
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def timed(key, eps):
        """(sums, kernel launches of one call, ms a call) of a row."""
        def call():
            return energy.pair_potential(pos, mass, eps=eps)

        before = energy.KERNEL_LAUNCHES["pair_potential_kernels"]
        got = call()
        launched = energy.KERNEL_LAUNCHES["pair_potential_kernels"] - before
        if not torch.equal(got, bits.setdefault(key, got)):
            raise SystemExit(f"potential_layouts: {key} changed its bits")
        return got, launched, cs.cuda_ms(call, 3)

    try:
        for key in (layouts + mode_rows) + (layouts + mode_rows)[::-1]:
            if key in layouts:
                _build._libs["direct"] = ctypes.CDLL(built[key][0])
                row = rows[key]
                for slots in slot_list:
                    energy.POTENTIAL_SLOTS = slots
                    got, launched, ms = timed((key, slots), 0.0)
                    row["ms"].setdefault(str(slots), []).append(ms)
                    row.setdefault("launches_per_call", {})[str(slots)] = (
                        launched)
                    first = got if first is None else first
                    row["rel_to_first"] = max(row.get("rel_to_first", 0.0),
                                              rel_err(got, first))
                energy.POTENTIAL_SLOTS = default_slots
            else:
                mode, eps = key
                row = rows[key]
                _build._libs["direct"] = ctypes.CDLL(
                    built[f"mode:{mode}"][0])
                got, row["launches_per_call"], ms = timed(key, eps)
                row["ms"].append(ms)
                row["same_bits_as_first_mode"] = bool(torch.equal(
                    got, by_eps.setdefault(eps, got)))
    finally:
        energy.POTENTIAL_SLOTS = default_slots
        smi.terminate()
    samples = [[float(v) for v in ln.split(",")]
               for ln in smi.communicate()[0].splitlines()
               if ln.count(",") == 1]
    bad = [r["layout"] for k, r in rows.items()
           if k in layouts and r["rel_to_first"] > 1e-5]
    bad += [f"{r['mode']}@{r['eps']}" for k, r in rows.items()
            if k not in layouts and not r["same_bits_as_first_mode"]]
    for row in rows.values():
        print(json.dumps(row), flush=True)
    default = "x".join(str(const[k])
                       for k in ("POT_P", "POT_WARPS", "POT_UNROLL"))
    print(json.dumps({"n": n, "pairs": pairs,
                      "default": {"layout": default, "slots": default_slots},
                      "failed": bad, "under_load": load(samples),
                      "nvidia_smi": card["smi"]}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
