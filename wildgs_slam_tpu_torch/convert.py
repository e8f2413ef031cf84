"""Carry weights and state from numpy copies of the JAX package's
structures into the port's. Numpy in, torch out; nothing here imports JAX.

- ``uncertainty_params_from_jax``: the flax tree of ``UncertaintyMLP``
  (``{"params": {"fc1": {"kernel": (in, out), "bias": (out,)}, ...}}``, or
  the inner dict) -> the torch module's ``state_dict``;
- ``droid_params_from_jax``: the flax tree of ``init_droid_params`` /
  ``load_droid_checkpoint`` (``{"fnet": ..., "cnet": ..., "update": ...}``,
  conv kernels HWIO) -> the ``DroidNet`` ``state_dict`` (upstream
  ``droid.pth`` names, OIHW);
- ``gaussian_map_from_numpy``: a ``GaussianMap`` as a dict
  ``{"params": {...}, "aux": {...}, "mu": {...}, "nu": {...}, "count": n}``
  of numpy arrays (the JAX ``adam.mu``/``adam.nu``/``adam.count``);
- ``viewpoint_store_from_numpy`` / ``keyframe_store_from_numpy``: dicts of
  numpy arrays keyed by field name.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .slam import gaussian_map as gm
from .slam import keyframe_store as kstore
from .slam import viewpoints


def _t(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def uncertainty_params_from_jax(tree: Mapping) -> dict:
    """Flax Dense layers (kernel (in, out)) -> nn.Linear state_dict
    (weight (out, in))."""
    layers = tree.get("params", tree)
    sd = {}
    for name in ("fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = torch.as_tensor(
            np.array(layers[name]["kernel"], np.float32).T.copy())
        sd[f"{name}.bias"] = torch.as_tensor(
            np.array(layers[name]["bias"], np.float32))
    return sd


def droid_params_from_jax(tree: Mapping) -> dict:
    """Flax DROID params -> DroidNet state_dict."""
    sd = {}

    def conv(key, p):
        sd[f"{key}.weight"] = torch.as_tensor(
            np.array(p["kernel"], np.float32).transpose(3, 2, 0, 1).copy())
        sd[f"{key}.bias"] = torch.as_tensor(np.array(p["bias"], np.float32))

    for enc in ("fnet", "cnet"):
        p = tree[enc]
        conv(f"{enc}.conv1", p["conv1"])
        conv(f"{enc}.conv2", p["conv2"])
        for li in (1, 2, 3):
            for bi in (0, 1):
                blk = p[f"layer{li}_{bi}"]
                pre = f"{enc}.layer{li}.{bi}"
                conv(f"{pre}.conv1", blk["conv1"])
                conv(f"{pre}.conv2", blk["conv2"])
                if "downsample" in blk:
                    conv(f"{pre}.downsample.0", blk["downsample"])
    u = tree["update"]
    for key, name in (("corr_encoder.0", "corr_enc1"),
                      ("corr_encoder.2", "corr_enc2"),
                      ("flow_encoder.0", "flow_enc1"),
                      ("flow_encoder.2", "flow_enc2"),
                      ("delta.0", "delta1"), ("delta.2", "delta2"),
                      ("weight.0", "weight1"), ("weight.2", "weight2"),
                      ("agg.conv1", "conv1"), ("agg.conv2", "conv2"),
                      ("agg.eta.0", "eta"), ("agg.upmask.0", "upmask")):
        conv(f"update.{key}", u["agg"][name] if key.startswith("agg")
             else u[name])
    for name, p in u["gru"].items():
        conv(f"update.gru.{name}", p)
    return sd


def _params(d: Mapping, device) -> gm.GaussianParams:
    return gm.GaussianParams(*[_t(d[n], device, torch.float32)
                               for n in gm.PARAM_NAMES])


def gaussian_map_from_numpy(d: Mapping, device="cuda") -> gm.GaussianMap:
    aux = d["aux"]
    return gm.GaussianMap(
        params=_params(d["params"], device),
        aux=gm.GaussianAux(
            alive=_t(aux["alive"], device, torch.bool),
            kf_id=_t(aux["kf_id"], device, torch.int32),
            n_obs=_t(aux["n_obs"], device, torch.int32),
            xyz_grad_accum=_t(aux["xyz_grad_accum"], device, torch.float32),
            denom=_t(aux["denom"], device, torch.float32),
            max_radii2d=_t(aux["max_radii2d"], device, torch.float32)),
        mu=_params(d["mu"], device), nu=_params(d["nu"], device),
        count=int(d["count"]))


def viewpoint_store_from_numpy(d: Mapping, device="cuda"):
    """Colours and features are given as float32 numpy arrays (numpy has no
    bfloat16) and stored back in bfloat16; values already rounded to
    bfloat16 survive the round trip exactly."""
    bf16 = {"colors", "features"}
    kinds = {"exposure_count": torch.int32, "valid": torch.bool}
    return viewpoints.ViewpointStore(**{
        k: _t(v, device, torch.float32).to(torch.bfloat16) if k in bf16
        else _t(v, device, kinds.get(k, torch.float32))
        for k, v in d.items()})


def keyframe_store_from_numpy(d: Mapping, device="cuda"):
    """Every KeyframeStore field, from `d`."""
    names = kstore.KeyframeStore.__dataclass_fields__
    kinds = {k: torch.bool for k in ("valid_depth_mask", "mono_mask_up",
                                     "valid_depth_mask_small", "dirty")}
    return kstore.KeyframeStore(**{
        k: _t(d[k], device, kinds.get(k, torch.float32)) for k in names})
