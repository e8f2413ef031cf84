"""Mid-run checkpoint and resume; the port's own copy of
``wildgs_slam_tpu/utils/checkpoint.py``.

The whole SLAM state goes into one npz: the keyframe store, the host
images, DINO features and timestamps, the Gaussian map with its Adam
moments, the view store (with the exposure moments), the uncertainty MLP
with its Adam state, the frontend graph's edges and edge state, the mapper's
window, counters and generators, and the motion filter's count. Keys and
meta fields are the JAX package's wherever the port holds the same state,
so a checkpoint the JAX package wrote loads here too (its ``mapper_key`` has
no counterpart; the port's torch generator is ``mapper_gen``). The file is
written to a temporary name and moved into place.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

GRAPH_LISTS = ("ii", "jj", "age", "ii_bad", "jj_bad", "ii_inac", "jj_inac")


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _put(arrays, prefix, obj):
    for f in dataclasses.fields(obj):
        arrays[prefix + f.name] = _np(getattr(obj, f.name))


def _get(arrays, prefix, obj):
    for f in dataclasses.fields(obj):
        t = getattr(obj, f.name)
        t.copy_(torch.as_tensor(arrays[prefix + f.name]).to(t.dtype))


def _mlp_key(name: str) -> str:
    """'fc1.weight' -> 'params/fc1/kernel' (flax layout, transposed)."""
    layer, kind = name.split(".")
    return f"params/{layer}/{'kernel' if kind == 'weight' else 'bias'}"


def save_slam_checkpoint(path: str, slam, loop_state: Dict[str, Any]
                         | None = None) -> None:
    """Serialize a SLAM system for resume. `loop_state` is the run loop's
    bookkeeping (next_frame, prev_kf_idx, prev_ba_idx)."""
    state, mapper = slam.state, slam.mapper
    g = mapper.gaussians
    arrays: Dict[str, np.ndarray] = {}
    _put(arrays, "store/", state.store)
    _put(arrays, "gaussians/params/", g.params)
    _put(arrays, "gaussians/aux/", g.aux)
    _put(arrays, "gaussians/adam/mu/", g.mu)
    _put(arrays, "gaussians/adam/nu/", g.nu)
    arrays["gaussians/adam/count"] = np.asarray(g.count, np.int32)
    _put(arrays, "vstore/", mapper.vstore)
    adam = mapper.uncer_adam
    for (name, p), m, v in zip(mapper.uncer_mlp.named_parameters(), adam.mu,
                               adam.nu):
        for prefix, t in (("uncer_params/", p), ("uncer_mu/", m),
                          ("uncer_nu/", v)):
            a = _np(t)
            arrays[prefix + _mlp_key(name)] = a.T if a.ndim == 2 else a
    arrays["uncer_count"] = np.asarray(adam.count, np.int32)
    arrays["mapper_gen"] = mapper.gen.get_state().numpy()
    arrays["images"] = state.images
    if state.dino_feats is not None:
        arrays["dino_feats"] = state.dino_feats
    arrays["timestamps"] = state.timestamps

    gr = slam.frontend.graph
    for name in GRAPH_LISTS:
        arrays[f"graph/{name}"] = np.asarray(getattr(gr, name))
    for name in ("net", "inp", "target", "weight", "target_inac",
                 "weight_inac", "damping"):
        arrays[f"graph/{name}"] = _np(getattr(gr, name))

    meta = dict(
        counter=state.counter,
        iteration_count=mapper.iteration_count,
        iters_after_densify=mapper.iters_after_densify,
        current_window=mapper.current_window,
        is_kf=mapper.is_kf,
        video_idxs=mapper.video_idxs,
        frame_idxs=mapper.frame_idxs,
        occ_aware_visibility={int(k): _np(v) for k, v in
                              mapper.occ_aware_visibility.items()},
        mapper_rng=mapper.rng.get_state(),
        frontend_t1=slam.frontend.t1,
        frontend_initialized=slam.frontend.is_initialized,
        frontend_kf_dropped=slam.frontend.num_keyframes_dropped,
        motion_filter_count=slam.motion_filter.count,
        loop_state=loop_state or {},
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=np.frombuffer(
        pickle.dumps(meta), dtype=np.uint8), **arrays)
    os.replace(tmp, path)


@torch.no_grad()
def load_slam_checkpoint(path: str, slam) -> Dict[str, Any]:
    """Restore a checkpoint (the port's or the JAX package's) into a freshly
    built SLAM system of the same config. Returns the saved loop_state."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    meta = pickle.loads(arrays.pop("__meta__").tobytes())
    state, mapper = slam.state, slam.mapper
    g = mapper.gaussians
    dev = state.store.poses.device
    _get(arrays, "store/", state.store)
    _get(arrays, "gaussians/params/", g.params)
    _get(arrays, "gaussians/aux/", g.aux)
    _get(arrays, "gaussians/adam/mu/", g.mu)
    _get(arrays, "gaussians/adam/nu/", g.nu)
    g.count = int(arrays["gaussians/adam/count"])
    if getattr(mapper, "mesh", None) is not None:
        # mesh mode: the map (its capacity padded for the mesh) is checked
        # against the mesh again; the sharded functions split it per call
        from ..parallel import mesh as pmesh

        mapper.gaussians = pmesh.shard_gaussian_map(g, mapper.mesh)
    _get(arrays, "vstore/", mapper.vstore)
    adam = mapper.uncer_adam
    for (name, p), m, v in zip(mapper.uncer_mlp.named_parameters(), adam.mu,
                               adam.nu):
        for prefix, t in (("uncer_params/", p), ("uncer_mu/", m),
                          ("uncer_nu/", v)):
            a = arrays[prefix + _mlp_key(name)]
            t.copy_(torch.as_tensor(a.T if a.ndim == 2 else a))
    adam.count = int(arrays["uncer_count"])
    if "mapper_gen" in arrays:
        mapper.gen.set_state(torch.as_tensor(arrays["mapper_gen"]))
    state.images[:] = arrays["images"]
    if state.dino_feats is not None and "dino_feats" in arrays:
        state.dino_feats[:] = arrays["dino_feats"]
    state.timestamps[:] = arrays["timestamps"]

    state.counter = meta["counter"]
    mapper.iteration_count = meta["iteration_count"]
    mapper.iters_after_densify = meta["iters_after_densify"]
    mapper.current_window = list(meta["current_window"])
    mapper.is_kf = dict(meta["is_kf"])
    mapper.video_idxs = list(meta["video_idxs"])
    mapper.frame_idxs = list(meta["frame_idxs"])
    mapper.occ_aware_visibility = {
        int(k): torch.as_tensor(v, device=dev)
        for k, v in meta.get("occ_aware_visibility", {}).items()}
    if "mapper_rng" in meta:
        mapper.rng.set_state(meta["mapper_rng"])
    for v in mapper.video_idxs:
        # copies: on the CPU .numpy() would alias the view-store row that
        # the mapper overwrites before it reads the old pose
        mapper.cam_w2c_old[v] = mapper.vstore.w2c[v].cpu().numpy().copy()
        mapper.depth_dict[v] = mapper.vstore.depths[v].clone()

    # the frontend's graph; its correlation volumes come from store.fmaps
    if "graph/ii" in arrays:
        gr = slam.frontend.graph
        for name in GRAPH_LISTS:
            setattr(gr, name, arrays[f"graph/{name}"].astype(np.int64))
        gr.damping = torch.as_tensor(arrays["graph/damping"],
                                     dtype=torch.float32, device=dev)
        gr.restore_edge_state(
            arrays["graph/net"], arrays["graph/inp"],
            arrays["graph/target"], arrays["graph/weight"],
            arrays["graph/target_inac"], arrays["graph/weight_inac"])

    fe = slam.frontend
    fe.t1 = meta["frontend_t1"]
    fe.is_initialized = meta["frontend_initialized"]
    fe.num_keyframes_dropped = meta.get("frontend_kf_dropped", 0)

    # the motion filter's last keyframe features live in the store
    mf = slam.motion_filter
    mf.count = meta.get("motion_filter_count", 0)
    if state.counter > 0:
        idx = state.counter - 1
        mf.fmap = state.store.fmaps[idx].clone()
        mf.net = state.store.nets[idx].clone()
        mf.inp = state.store.inps[idx].clone()
    return meta.get("loop_state", {})
