"""Config system: YAML with recursive ``inherit_from`` chains + deep merge.

The port's own copy of ``wildgs_slam_tpu/config.py`` (same semantics as the
reference's src/config.py). ``inherit_from`` paths in the repository's
configs are written relative to the repository root; besides the working
directory and the including file's directory, the loader also resolves them
against each parent directory of the including file, so a config loads from
any working directory.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import yaml


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Deep-merge src into dst in place."""
    for k, v in src.items():
        if k not in dst:
            dst[k] = dict() if isinstance(v, dict) else v
        if isinstance(v, dict):
            update_recursive(dst[k], v)
        else:
            dst[k] = v


def _resolve(inherit_from: str, including: str) -> str:
    if os.path.isabs(inherit_from) or os.path.exists(inherit_from):
        return inherit_from
    d = os.path.dirname(os.path.abspath(including))
    while True:
        candidate = os.path.join(d, inherit_from)
        if os.path.exists(candidate):
            return candidate
        parent = os.path.dirname(d)
        if parent == d:
            return inherit_from
        d = parent


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config, following its ``inherit_from`` chain."""
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f)

    inherit_from = cfg_special.get("inherit_from")
    cfg = ({} if inherit_from is None
           else load_config(_resolve(inherit_from, path)))

    update_recursive(cfg, cfg_special)
    return cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        yaml.dump(cfg, f, default_flow_style=False, sort_keys=False)
