"""Carry weights and state from numpy copies of the JAX package's
structures into the port's. Numpy in, torch out; nothing here imports JAX.

- ``uncertainty_params_from_jax``: the flax tree of ``UncertaintyMLP``
  (``{"params": {"fc1": {"kernel": (in, out), "bias": (out,)}, ...}}``, or
  the inner dict) -> the torch module's ``state_dict``;
- ``droid_params_from_jax``: the flax tree of ``init_droid_params`` /
  ``load_droid_checkpoint`` (``{"fnet": ..., "cnet": ..., "update": ...}``,
  conv kernels HWIO) -> the ``DroidNet`` ``state_dict`` (upstream
  ``droid.pth`` names, OIHW);
- ``dinov2_state_from_jax`` / ``depth_anything_state_from_jax``: the flax
  trees of the JAX ``DINOv2`` / ``DepthAnythingV2`` (as ``load_torch_dinov2``
  / ``load_torch_depth_anything`` make them) -> the port's ``state_dict``
  (upstream names);
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


def _conv(p) -> torch.Tensor:
    """Flax kernel (kh, kw, in, out) -> OIHW. The same transpose takes a
    transposed convolution's (kh, kw, out, in) (``transpose_kernel=True``)
    to torch's (in, out, kh, kw)."""
    return torch.as_tensor(np.array(p["kernel"], np.float32).transpose(
        3, 2, 0, 1).copy())


def _vec(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32))


def dinov2_state_from_jax(tree: Mapping) -> dict:
    """Flax DINOv2 params -> the port's DINOv2 state_dict (the unused
    ``mask_token``, absent there, is zeros)."""
    sd = {"patch_embed.proj.weight": _conv(tree["patch_embed"]),
          "patch_embed.proj.bias": _vec(tree["patch_embed"]["bias"]),
          "cls_token": _vec(tree["cls_token"]),
          "pos_embed": _vec(tree["pos_embed"]),
          "norm.weight": _vec(tree["norm"]["scale"]),
          "norm.bias": _vec(tree["norm"]["bias"]),
          "mask_token": torch.zeros(1, np.shape(tree["cls_token"])[-1])}
    if "register_tokens" in tree:
        sd["register_tokens"] = _vec(tree["register_tokens"])
    i = 0
    while f"block{i}" in tree:
        b, p = tree[f"block{i}"], f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = _vec(b[n]["scale"])
            sd[f"{p}.{n}.bias"] = _vec(b[n]["bias"])
        for key, d in (("attn.qkv", b["attn"]["qkv"]),
                       ("attn.proj", b["attn"]["proj"]),
                       ("mlp.fc1", b["mlp_fc1"]), ("mlp.fc2", b["mlp_fc2"])):
            sd[f"{p}.{key}.weight"] = torch.as_tensor(
                np.array(d["kernel"], np.float32).T.copy())
            sd[f"{p}.{key}.bias"] = _vec(d["bias"])
        sd[f"{p}.ls1.gamma"] = _vec(b["ls1_gamma"])
        sd[f"{p}.ls2.gamma"] = _vec(b["ls2_gamma"])
        i += 1
    return sd


def depth_anything_state_from_jax(tree: Mapping) -> dict:
    """Flax DepthAnythingV2 params -> the port's state_dict. refinenet4's
    first residual unit, which the forward never runs and a flax init does
    not create, is zeros when the tree lacks it."""
    sd = {f"pretrained.{k}": v
          for k, v in dinov2_state_from_jax(tree["pretrained"]).items()}
    h, o = tree["depth_head"], "depth_head."

    def conv(key, p, bias=True):
        sd[o + key + ".weight"] = _conv(p)
        if bias:
            sd[o + key + ".bias"] = _vec(p["bias"])
    for i in range(4):
        conv(f"projects.{i}", h[f"project{i}"])
        conv(f"scratch.layer{i + 1}_rn", h[f"layer{i + 1}_rn"], bias=False)
    conv("resize_layers.0", h["resize0"])
    conv("resize_layers.1", h["resize1"])
    conv("resize_layers.3", h["resize3"])
    for i in range(1, 5):
        r = h[f"refinenet{i}"]
        rcu1 = r.get("rcu1") or {
            n: {"kernel": np.zeros_like(r["rcu2"][n]["kernel"]),
                "bias": np.zeros_like(r["rcu2"][n]["bias"])}
            for n in ("conv1", "conv2")}
        for name, unit in (("resConfUnit1", rcu1), ("resConfUnit2",
                                                    r["rcu2"])):
            for n in ("conv1", "conv2"):
                conv(f"scratch.refinenet{i}.{name}.{n}", unit[n])
        conv(f"scratch.refinenet{i}.out_conv", r["out_conv"])
    conv("scratch.output_conv1", h["output_conv1"])
    conv("scratch.output_conv2.0", h["output_conv2_0"])
    conv("scratch.output_conv2.2", h["output_conv2_2"])
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
