"""Each traffic mix runs at a small size on the CPU through the whole
harness, in a fresh process, and loads no module of JAX or of the JAX
package; without a card the command exits 2 and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from h100_bench import run as hr
from h100_bench.tests import small

REHEARSAL = """
import json, sys
from h100_bench import run as hr
from h100_bench.tests import small
r = small.measure(sys.argv[1], trace=sys.argv[2] == "1")
print(json.dumps(dict(result=r, loaded=hr.forbidden_modules(),
                      torch_cuda=sys.modules["torch"].cuda.is_available())))
"""


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = hr.ROOT
    return env


@pytest.mark.parametrize("workload", [w["name"] for w in small.spec()[
    "workloads"]])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_rehearsal(workload, trace):
    p = subprocess.run([sys.executable, "-c", REHEARSAL, workload, trace],
                       cwd=hr.ROOT, env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    r = out["result"]
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = set(r["metrics"])
    spec = small.spec()
    e2e = {m["name"] for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])}
    if trace == "1":
        assert names and not names & e2e
        # the CPU has no device trace: only host spans and counters read
        host = {m["name"] for m in spec["per_layer"]
                if workload in m["workloads"]
                and m["source"] in ("host_clock", "program_span",
                                    "program_counter")}
        assert host <= names
    else:
        assert names == e2e


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload",
         small.spec()["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=hr.ROOT, env=dict(_env(), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
