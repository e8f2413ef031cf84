"""The readings that the cells' limits are set from, on the card:

    python3 -m h100_bench.readings --workload <cell> --seeds 1,2,3 \
        [--control 3] [--fault 3] [--seconds 20]

For each seed, one set-up of the cell as a run makes it, a window, and
what it compares against the reference: the program's numbers. A mapping
cell's window takes one keyframe, the one its check is drawn from; a
tracking cell's runs ``--seconds`` and on, untimed, until every unit drawn
for the check has come. For the first ``--control`` seeds also the control, the
reference computed with TF32 matmuls and convolutions put in the program's
place, and, for a mapping cell, for the first ``--fault`` seeds a planted
fault, the reference that leaves out the lower half of every image. One
JSON line per seed and reading; a mapping cell's has each leaf's norms
beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from h100_bench import run as hr
from h100_bench.drivers import mapping as dm
from h100_bench.drivers import tracking as dt


def leaf_table(side, reference):
    rows = {}
    for n in reference["grads"]:
        rows[n] = [dm._norm(reference["grads"][n]),
                   dm._norm(side["grads"][n]),
                   dm._norm(reference["changes"][n]),
                   dm._norm(side["changes"][n])]
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", type=int, default=3)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    spec = hr.load_json(hr.ROOT, "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = hr.load_json(hr.ROOT, conf["file"])["config"]
    mix = hr.load_json(hr.HERE, "traffic", f"{cell['traffic']}.json")
    dev = torch.device("cuda:0")
    if mix["driver"] == "tracking":
        return tracking(args, cfg, mix, dev)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = dm.MappingCell(cfg, mix, seed, dev)
        c.setup()
        t_setup = time.perf_counter() - t0
        c.window(0.0, None)
        cap = c.capture
        assert cap.complete(), (seed, cap.at)
        c.release()
        ref = dm.reference_run(cap, cfg, mix, seed, dev)
        prog = dm.program_run(cap)
        sides = [("program", prog)]
        if k < args.control:
            sides.append(("control_tf32", dm.reference_run(
                cap, cfg, mix, seed, dev, tf32=True)))
        if k < args.fault:
            sides.append(("fault_half", dm.reference_run(
                cap, cfg, mix, seed, dev, fault="half")))
        for name, side in sides:
            print(json.dumps(dict(
                workload=args.workload, seed=seed, side=name,
                numbers=dm.numbers(side, ref), setup_s=t_setup,
                at=cap.at, steps=[(a["idx"], a["freeze"], a["it_count"])
                                  for a in cap.args],
                losses=[side["losses"], ref["losses"]],
                leaves=leaf_table(side, ref))), flush=True)
        del cap, ref, prog, sides
        torch.cuda.empty_cache()


def tracking(args, cfg, mix, dev):
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        c = dt.TrackingCell(cfg, mix, seed, dev)
        c.setup()
        t_setup = time.perf_counter() - t0
        out = c.window(args.seconds, dt.draw_iterations(seed, mix), None)
        weights = c.weights
        c.release()
        sides = [("program", dt.reference_numbers(out, weights))]
        if k < args.control:
            sides.append(("control_tf32", dt.reference_numbers(
                out, weights, tf32=True)))
        for name, nums in sides:
            print(json.dumps(dict(
                workload=args.workload, seed=seed, side=name, numbers=nums,
                setup_s=t_setup, frames=out["frames"],
                keyframes=out["keyframes"], wanted=out["wanted"],
                captured=len(out["records"]), late_s=out["late_s"],
                mf_frame=out["mf"] and out["mf"]["frame"],
                ms_per_frame=out["e2e"]["track_ms_per_frame"])), flush=True)
        del out, sides
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
