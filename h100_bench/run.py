"""The benchmark of ``wildgs_slam_tpu_torch`` on one NVIDIA H100.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root. ``BENCHMARK.json`` names the cell's
configuration (``h100_bench/configs/<config>.json``) and its traffic mix
(``h100_bench/traffic/<mix>.json``); the mix names its driver
(``h100_bench/drivers/<driver>.py``), the cell's limits are in
``h100_bench/limits/<cell>.json`` and each per-layer metric is read by
``h100_bench/metrics/<metric>.py``. A new cell, mix or metric is new files
and a new entry in ``BENCHMARK.json``.

The run sets up (counted in ``setup_s`` from the start of this process),
measures for ``--seconds`` with whole units, checks what the timed path
produced against the plain reference in ``h100_bench/reference/``, and
prints one JSON object as the last line of standard output. ``--trace 1``
reports the per-layer metrics instead of the end-to-end ones. Without a
CUDA device, or with fewer than the cell asks for, it exits 2 and prints
no result; it exits 3 if the process holds a module of JAX or of the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "wildgs_slam_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported or (
        metric["name"] == "setup_s")


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0)
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
               count=1)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
             "nounits", f"--id={device.index or 0}"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
        out["power_limit_w"] = float(line.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def verdict(numbers: dict, limits: dict, failed: int):
    """(correct, {name: {value, limit}}): every compared number finite and
    within its limit, and no unit failed."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()), checks


def measure(spec: dict, workload: str, seed: int, seconds: float,
            trace_on: bool, device, config=None, traffic=None,
            t_start=None) -> dict:
    """One run of `workload` on `device`; returns the result object.
    `config` / `traffic` replace the cell's files (the tests' small
    sizes)."""
    import torch

    device = torch.device(device)
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = config or load_json(ROOT, conf["file"])["config"]
    mix = traffic or load_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = load_json(HERE, "limits", f"{workload}.json")
    driver = importlib.import_module(f"h100_bench.drivers.{mix['driver']}")
    peaks = load_json(HERE, "peaks.json")

    out = driver.run(cfg, mix, seed, seconds, trace_on, device,
                     t_start=T_START if t_start is None else t_start)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    nums = out["numbers"]
    correct, checks = verdict(nums, limits, out["failed"])
    reported = set(out["e2e"]) | {"setup_s"}
    metrics = {}
    if not trace_on:
        for m in spec["end_to_end"]:
            if applies(m, workload, reported):
                metrics[m["name"]] = {"value": out["setup_s"] if m["name"]
                                      == "setup_s" else out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = dict(out, peaks=peaks, config=cfg, workload=workload)
        for m in spec["per_layer"]:
            if applies(m, workload, reported):
                v = load_metric(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = card(device)
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace_on:
        st = out["stretch"]
        dev["busy_s"], dev["window_s"] = st["busy_s"], st["wall_s"]
        result["breakdown"] = {"device_ops": st["device_ops"],
                               "idle_gaps": st["idle_gaps"]}
    result["info"] = {"setup_s": out["setup_s"],
                      "window_s": out["window_s"],
                      "reference_s": out["reference_s"],
                      "units": out["attempted"],
                      "unit_s": [round(x, 4) for x in out["unit_s"]],
                      "numbers": {k: v for k, v in nums.items()
                                  if k not in limits}}
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this benchmark measures CUDA devices: {need} needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    try:
        result = measure(spec, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0")
    except ForbiddenModules as e:
        print(f"modules of JAX or of the JAX package are loaded: {e}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
