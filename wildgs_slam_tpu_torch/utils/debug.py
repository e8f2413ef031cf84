"""Anomaly detection; the port's own copy of
``wildgs_slam_tpu/utils/debug.py``.

- ``enable()`` turns on ``torch.autograd.set_detect_anomaly`` (the JAX
  package's ``jax_debug_nans``: a backward that makes a NaN raises at the
  operation that made it) and arms the phase checks;
- ``anomaly_check(name, *trees)``, called at phase boundaries, tests every
  floating-point tensor in the trees (tensors, dataclasses, dicts, lists and
  tuples of them) for finite values with one host synchronization, and
  raises ``AnomalyError`` naming the phase and the first bad leaf. Disabled,
  it returns at once.

Enable with config ``debug: {detect_anomaly: true}``, ``--debug`` or the
environment variable WILDGS_DETECT_ANOMALY=1.
"""

from __future__ import annotations

import dataclasses
import os

import torch

_ENABLED = bool(int(os.environ.get("WILDGS_DETECT_ANOMALY", "0")))


class AnomalyError(RuntimeError):
    """A non-finite value crossed a phase boundary."""


def enable(detect_anomaly: bool = True) -> None:
    """Arm the phase checks (and, by default, autograd's anomaly mode)."""
    global _ENABLED
    _ENABLED = True
    if detect_anomaly:
        torch.autograd.set_detect_anomaly(True)


def disable() -> None:
    global _ENABLED
    _ENABLED = False
    torch.autograd.set_detect_anomaly(False)


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def anomaly_check(name: str, *trees) -> None:
    """If armed: raise AnomalyError unless every floating-point tensor in
    `trees` is finite."""
    if not _ENABLED:
        return
    leaves = [(p, t) for tree in trees for p, t in _leaves(tree)
              if t.is_floating_point()]
    if not leaves:
        return
    ok = torch.stack([torch.isfinite(t).all() for _, t in leaves]).cpu()
    if bool(ok.all()):
        return
    path, t = leaves[int((~ok).nonzero()[0])]
    bad = int((~torch.isfinite(t)).sum())
    raise AnomalyError(
        f"phase '{name}': {bad}/{t.numel()} non-finite values at leaf "
        f"{path or '<root>'} (shape {tuple(t.shape)}, dtype {t.dtype})")


def maybe_enable_from_cfg(cfg: dict) -> None:
    dbg = cfg.get("debug", {})
    if dbg.get("detect_anomaly", False):
        flag = bool(dbg.get("debug_nans", True))
        enable(detect_anomaly=flag)
        print(f"[debug] anomaly detection armed (set_detect_anomaly={flag})")
