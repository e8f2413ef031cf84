"""The plain reference against the port at a small size on the CPU, and
the reference's independence: its files import nothing of JAX, the JAX
package or the port (whole top-level names)."""

import ast
import os

import pytest
import torch

from h100_bench import run as hr
from h100_bench.drivers import mapping as dm
from h100_bench.tests import small

REF_DIR = os.path.join(hr.HERE, "reference")
FORBIDDEN = {"jax", "jaxlib", "flax", "wildgs_slam_tpu",
             "wildgs_slam_tpu_torch"}


def imported_top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.add(".")
            else:
                names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = [f for f in os.listdir(REF_DIR) if f.endswith(".py")]
    assert "mapping.py" in files
    for f in files:
        names = imported_top_names(os.path.join(REF_DIR, f))
        assert not names & FORBIDDEN, (f, names & FORBIDDEN)
        assert "." not in names, f"{f} imports relatively"


@pytest.fixture(scope="module")
def small_run():
    return dm.run(small.config("tum_dynamic"), small.traffic("map_online"),
                  2 ** 31 + 12345, 0.05, False, "cpu")


def test_port_agrees_with_the_reference(small_run):
    n = small_run["numbers"]
    # the port's step on the CPU is plain torch too: they differ by the
    # order of float32 sums
    assert n["loss_gap"] < 1e-5
    assert n["grad_gap"] < 1e-4
    assert n["seed_gap"] < 1e-4
    assert n["leaves_compared"] >= 6
    ok, _ = hr.verdict(n, hr.load_json(hr.HERE, "limits",
                                       "tum_dynamic.map_online.json"),
                       small_run["failed"])
    assert ok


def test_window_counts_its_units(small_run):
    assert small_run["attempted"] >= 1 and small_run["failed"] == 0
    assert small_run["iterations"] >= 30
    assert small_run["e2e"]["map_ms_per_iter"] > 0
    assert small_run["setup_s"] > 0


def test_reference_follows_its_own_steps():
    """Two reference runs from one capture agree exactly (no state of the
    program is read after the capture)."""
    cell = dm.MappingCell(small.config("tum_dynamic"),
                          small.traffic("map_online"), 3, "cpu")
    cell.setup()
    cell.window(0.0, None)
    cap = cell.capture
    cell.release()
    a = dm.reference_run(cap, small.config("tum_dynamic"),
                         small.traffic("map_online"), 3,
                         torch.device("cpu"))
    b = dm.reference_run(cap, small.config("tum_dynamic"),
                         small.traffic("map_online"), 3,
                         torch.device("cpu"))
    assert a["losses"] == b["losses"]
    n = dm.numbers(a, b)
    assert n["loss_gap"] == n["grad_gap"] == n["change_gap"] == 0.0
