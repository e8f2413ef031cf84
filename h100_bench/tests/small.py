"""Small sizes of the cells for the CPU tests: the configurations' files
with the camera at 48x64, 8,192 Gaussians, lists of 64 and short
optimisations, and three warmup keyframes."""

import copy

from h100_bench import run as hr


def spec():
    return hr.load_json(hr.ROOT, "BENCHMARK.json")


def config(name, driver="mapping"):
    c = copy.deepcopy(hr.load_json(hr.HERE, "configs", f"{name}.json")[
        "config"])
    if driver == "tracking":
        # 1/8 resolution 8x16: the correlation pyramid's coarsest level
        # keeps a pixel
        c["cam"].update(H=64, W=128, H_out=64, W_out=128, H_edge=0,
                        W_edge=0, fx=80.0, fy=80.0, cx=64.0, cy=32.0)
        c["tracking"].update(buffer=40, warmup=5)
        return c
    c["cam"].update(H=48, W=64, H_out=48, W_out=64, H_edge=0, W_edge=0,
                    fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    mc = c["mapping"]
    mc.update(gaussian_capacity=8192, render_list_capacity=64)
    # 23 steps after the initial densification at 25, past the 20-step
    # freeze, as at full size; the window's first keyframe has places for
    # the compared steps past its own first 20
    mc["Training"].update(init_itr_num=48, init_gaussian_update=25,
                          mapping_itr_num=30)
    c["tracking"]["buffer"] = 40
    return c


def traffic(name, profile=True):
    t = copy.deepcopy(hr.load_json(hr.HERE, "traffic", f"{name}.json"))
    if t["driver"] == "mapping":
        t["init_keyframes"] = 3
        t["profile"] = {"start": 5, "steps": 3} if profile else None
    else:
        t.update(check_within=4, check_iterations=2, check_mf_frames=[3, 5])
        t["profile"] = {"start": 1, "frames": 2} if profile else None
    return t


def measure(workload, seed=7, trace=False):
    s = spec()
    cell = next(w for w in s["workloads"] if w["name"] == workload)
    t = traffic(cell["traffic"])
    # a tracking window long enough for the drawn graph iterations
    seconds = 0.05 if t["driver"] == "mapping" else 4.0
    return hr.measure(s, workload, seed, seconds, trace, "cpu",
                      config=config(cell["config"], t["driver"]),
                      traffic=t)
