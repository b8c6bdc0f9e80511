"""Readings the comparison's limits are set from, for one cell, in one
process: the program against the plain reference on a dozen seeds or
more, the control (the reference in fp8, in the program's place) and the
planted faults on a few seeds each, all at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds N
        --control-seeds M --out FILE

Not run by the benchmark's runs; its readings and the limits set from
them are in PERF.md.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def worst_leaves(prog: dict, ref: dict, key: str, n: int = 3):
    """The ``n`` leaves with the widest norm gaps of ``key``."""
    import statistics

    med = statistics.median(float(v) for v in ref[key].values())
    gaps = sorted(((abs(float(prog[key][p]) - float(v)) / max(float(v), med),
                    "/".join(p)) for p, v in ref[key].items()), reverse=True)
    return gaps[:n]


def readings(c, kind, setup, seed, device, fault=None, control=False,
             full=False):
    """The compared numbers for one seed: the program (or, with
    ``control``, the reference in fp8) against the float32 reference.
    ``full`` adds each step's losses, the widest leaves and the float64
    reference's reading against the float32 one."""
    import torch

    from portbench import faults, harness

    def weights():
        return harness.make_weights(kind.weights_spec(c["config"]), seed,
                                    device)

    with tempfile.TemporaryDirectory() as tmp:
        r = harness.start(c, kind, setup, seed, device, tmp,
                          None if fault is None else faults.FAULTS[fault])
        try:
            _, prog = harness.first_steps(c["config"], r["state"], r["step"],
                                          r["feed"], r["init_params"])
            rows = r["first_rows"] or r["feed"].seen[:harness.FIRST_STEPS]
        finally:
            r["feed"].close()
        del r
        torch.cuda.empty_cache()
    batches = [harness.reference_batch(setup["chunks"], rw, h, device)
               for rw, h in rows]
    ref = harness.run_reference(kind, c["config"], setup, weights(),
                                batches, seed, device)
    if control:
        prog = harness.run_reference(kind, c["config"], setup, weights(),
                                     batches, seed, device,
                                     prec=faults.FP8)
    out = {"numbers": harness.compare(prog, ref),
           "loss_gaps": harness.loss_gaps(prog, ref)}
    diffs = harness.leaf_diffs(prog["grad_vec"], ref["grad_vec"])
    out["grad_diff_worst"] = max(diffs.values())
    if full:
        out["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
        out["worst"] = {k: worst_leaves(prog, ref, k)
                        for k in ("grad", "change")}
        out["worst"]["grad_diff"] = sorted(
            (v, "/".join(p)) for p, v in diffs.items())[::-1][:6]
        f64 = harness.run_reference(kind, c["config"], setup, weights(),
                                    batches, seed, device,
                                    dtype=torch.float64)
        out["float64_vs_float32"] = {
            "numbers": harness.compare(ref, f64),
            "loss_gaps": harness.loss_gaps(ref, f64)}
        bf16 = harness.run_reference(kind, c["config"], setup, weights(),
                                     batches, seed, device,
                                     prec=faults.BF16)
        out["bf16_reference"] = {
            "numbers": harness.compare(bf16, ref),
            "grad_diff_worst": max(harness.leaf_diffs(
                bf16["grad_vec"], ref["grad_vec"]).values()),
            "loss_gaps": harness.loss_gaps(bf16, ref)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    device = torch.device("cuda", 0)
    print(f"card: {harness.card_line()}", flush=True)
    c = harness.load_cell(args.workload)
    kind = harness.kind_module(c["config"])
    t0 = time.perf_counter()
    setup = kind.host_setup(c["config"])
    kind.build_kernels(device)
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"workload": args.workload, "card": harness.card_line(),
           "program": {}, "control": {}, "half_batch": {},
           "unchanged_state": {}}
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, s in enumerate(seeds):
        out["program"][s] = readings(c, kind, setup, s, device,
                                     full=i < args.control_seeds)
        print("program", s, out["program"][s], flush=True)
    for i, s in enumerate(seeds[:args.control_seeds]):
        out["control"][s] = readings(c, kind, setup, s, device, control=True)
        print("control", s, out["control"][s], flush=True)
        if i < 3:
            for fault in ("half_batch", "unchanged_state"):
                out[fault][s] = readings(c, kind, setup, s, device,
                                         fault=fault)
                print(fault, s, out[fault][s], flush=True)
    for name in ("program", "control", "half_batch", "unchanged_state"):
        for k in ("grad_gap", "grad_diff", "change_gap"):
            vals = [v["numbers"][k] for v in out[name].values()]
            print(f"{name} {k}: min {min(vals):.4g} max {max(vals):.4g}",
                  flush=True)
        vals = [v["grad_diff_worst"] for v in out[name].values()]
        print(f"{name} grad_diff by the worst leaf: min {min(vals):.4g} "
              f"max {max(vals):.4g}", flush=True)
        for i in range(harness.FIRST_STEPS):
            vals = [v["loss_gaps"][i] for v in out[name].values()]
            print(f"{name} step {i + 1} loss gap: min {min(vals):.4g} "
                  f"max {max(vals):.4g}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
