"""The tracking ops of the port against the JAX package, on the CPU: the
rest of SE3/SO3, projective geometry with its Jacobians, the correlation
pyramid and lookup, the DROID network with converted weights, dense BA,
frame distances and the multiview depth-filter count.

Same seeded numpy inputs through both packages. Tolerances, and why:
- lie, projective, correlation lookup: 1e-5 absolute (float32 op order;
  the Jacobians are scaled so that entries stay O(10));
- droid_net outputs: 1e-4 absolute (three hundred thousand-term
  convolution sums in another order);
- BA: poses 1e-5 and disparities 1e-4 relative to the largest entry
  (the Gauss-Newton step goes through a Cholesky solve of a 6P system
  whose sums are taken in another order);
- frame distance: 1e-5 relative; the depth-filter count: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.models import droid_net as jdn
from wildgs_slam_tpu.ops import correlation as jcorr
from wildgs_slam_tpu.ops import dba as jdba
from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu.ops import projective as jproj
from wildgs_slam_tpu_torch import convert
from wildgs_slam_tpu_torch.models import droid_net as tdn
from wildgs_slam_tpu_torch.ops import correlation as tcorr
from wildgs_slam_tpu_torch.ops import dba as tdba
from wildgs_slam_tpu_torch.ops import lie as tlie
from wildgs_slam_tpu_torch.ops import projective as tproj

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


def rand_poses(rng, n, rot=0.3, trans=0.3):
    xi = np.concatenate([trans * rng.normal(size=(n, 3)),
                         rot * rng.normal(size=(n, 3))], -1)
    return np.array(jlie.se3_exp(J(xi.astype(np.float32))))


# ---------------------------------------------------------------------------
# lie
# ---------------------------------------------------------------------------

LIE_FNS = ["matrix_to_quat", "so3_log", "so3_left_jacobian_inv", "se3_log",
           "se3_act4", "se3_matrix", "se3_from_matrix", "se3_adj_matrix",
           "se3_adj", "se3_adjT", "se3_normalize"]


@pytest.mark.parametrize("name", LIE_FNS)
def test_lie(name):
    rng = np.random.RandomState(0)
    g = rand_poses(rng, 16, rot=1.0)
    g[:2, 3:] = [[0, 0, 0, 1], [0, 0, 0, -1]]       # identity, both signs
    g[2, 3:6] = 1e-5                                  # small angle
    phi = np.asarray(jlie.so3_log(J(g[:, 3:])))
    a = rng.normal(size=(16, 6)).astype(np.float32)
    p4 = rng.normal(size=(16, 4)).astype(np.float32)
    mats = np.asarray(jlie.se3_matrix(J(g)))
    args = {"matrix_to_quat": (mats[:, :3, :3],), "so3_log": (g[:, 3:],),
            "so3_left_jacobian_inv": (phi,), "se3_log": (g,),
            "se3_act4": (g, p4), "se3_matrix": (g,),
            "se3_from_matrix": (mats,), "se3_adj_matrix": (g,),
            "se3_adj": (g, a), "se3_adjT": (g, a),
            "se3_normalize": (g * 1.01,)}[name]
    ref = getattr(jlie, name)(*[J(x) for x in args])
    out = getattr(tlie, name)(*[T(x) for x in args])
    close(out, ref, 1e-5)


# ---------------------------------------------------------------------------
# projective
# ---------------------------------------------------------------------------

def _geometry(rng, F=4, h=6, w=8):
    poses = rand_poses(rng, F, rot=0.05, trans=0.1)
    disps = (0.3 + 0.4 * rng.uniform(size=(F, h, w))).astype(np.float32)
    intr = np.array([6.0, 6.5, w / 2, h / 2], np.float32)
    ii = np.array([0, 1, 2, 1, 3, 2], np.int64)
    jj = np.array([1, 0, 3, 2, 2, 2], np.int64)     # last one a self-edge
    return poses, disps, intr, ii, jj


def test_projective_transform_and_jacobians():
    rng = np.random.RandomState(1)
    poses, disps, intr, ii, jj = _geometry(rng)
    ref = jproj.projective_transform(J(poses), J(disps), J(intr), J(ii),
                                     J(jj), jacobian=True, return_depth=True)
    out = tproj.projective_transform(T(poses), T(disps), T(intr), T(ii),
                                     T(jj), jacobian=True, return_depth=True)
    close(out[0], ref[0], 1e-5)
    close(out[1], ref[1], 0)
    for a, b in zip(out[2], ref[2]):
        close(a, b, 1e-5)
    flow, valid = tproj.induced_flow(T(poses), T(disps), T(intr), T(ii),
                                     T(jj))
    rflow, rvalid = jproj.induced_flow(J(poses), J(disps), J(intr), J(ii),
                                       J(jj))
    close(flow, rflow, 1e-5)
    close(valid, rvalid, 0)


def test_iproj_proj_actp():
    rng = np.random.RandomState(2)
    poses, disps, intr, ii, _ = _geometry(rng)
    intr = np.tile(intr, (disps.shape[0], 1))
    X0 = tproj.iproj(T(disps), T(intr))
    close(X0, jproj.iproj(J(disps), J(intr)), 1e-6)
    for jac in (False, True):
        X1, Ja = tproj.actp(T(poses), X0, jacobian=jac)
        rX1, rJa = jproj.actp(J(poses), J(X0.numpy()), jacobian=jac)
        close(X1, rX1, 1e-5)
        c, Jp = tproj.proj(X1, T(intr), jacobian=jac, return_depth=True)
        rc, rJp = jproj.proj(J(X1.numpy()), J(intr), jacobian=jac,
                             return_depth=True)
        close(c, rc, 1e-5)
        if jac:
            close(Ja, rJa, 1e-6)
            close(Jp, rJp, 1e-5)


# ---------------------------------------------------------------------------
# correlation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corr_inputs():
    rng = np.random.RandomState(3)
    E, h, w = 3, 12, 16
    f1 = rng.normal(size=(E, h, w, 128)).astype(np.float32)
    f2 = rng.normal(size=(E, h, w, 128)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    coords = (grid[None] + 3.0 * rng.normal(size=(E, h, w, 2))).astype(
        np.float32)
    coords[0, 0, 0] = [-20.0, 50.0]                   # far out of bounds
    return f1, f2, coords


def test_corr_pyramid(corr_inputs):
    f1, f2, _ = corr_inputs
    ref = jcorr.corr_pyramid(J(f1), J(f2))
    out = tcorr.corr_pyramid(T(f1), T(f2))
    for a, b in zip(out, ref):
        close(a, b, 1e-4)     # 128-term dot products of O(1) values
    packed = tcorr.pack_pyramid(out)
    for a, b in zip(tcorr.pyramid_levels(packed, 12, 16), out):
        close(a, b, 0)
    for a, b in zip(tcorr.fmap_pyramid(T(f1)), jcorr.fmap_pyramid(J(f1))):
        close(a, b, 1e-6)


@pytest.mark.parametrize("method", ["onehot", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_lookup(corr_inputs, method, dtype):
    """The port's gather lookup against the JAX default (one-hot) and gather
    forms, on the same volume, in float32 and in the stored bfloat16."""
    f1, f2, coords = corr_inputs
    pyr = [np.asarray(v) for v in jcorr.corr_pyramid(J(f1), J(f2))]
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    ref = jcorr.corr_lookup([J(v).astype(jd) for v in pyr], J(coords),
                            method=method)
    out = tcorr.corr_lookup([T(v).to(td) for v in pyr], T(coords))
    assert out.shape == (3, 12, 16, 196)
    close(out, ref, 1e-5)
    packed = tcorr.pack_pyramid([T(v).to(td) for v in pyr])
    close(tcorr.corr_lookup_packed(packed, T(coords)), out, 0)


# ---------------------------------------------------------------------------
# droid_net
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def droid():
    params = jdn.init_droid_params(jax.random.PRNGKey(0), 48, 64)
    model = tdn.DroidNet()
    model.load_state_dict(convert.droid_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model.eval()


def test_droid_state_dict_names(droid):
    """Upstream droid.pth names (with the trimmed 2-channel heads)."""
    _, model = droid
    sd = model.state_dict()
    for key in ("fnet.layer2.0.downsample.0.weight", "cnet.conv1.bias",
                "update.corr_encoder.2.weight", "update.flow_encoder.0.bias",
                "update.gru.convq_glo.weight", "update.agg.eta.0.weight",
                "update.agg.upmask.0.bias", "update.delta.2.weight"):
        assert key in sd, key
    assert sd["update.weight.2.weight"].shape == (2, 128, 3, 3)


@torch.no_grad()
def test_encoders(droid):
    params, model = droid
    rng = np.random.RandomState(4)
    img = rng.normal(size=(2, 48, 64, 3)).astype(np.float32)
    close(model.fnet(T(img)), jdn.apply_fnet(params, J(img)), 1e-4)
    ctx = model.cnet(T(img))
    rctx = jdn.apply_cnet(params, J(img))
    close(ctx, rctx, 1e-4)
    for a, b in zip(tdn.context_split(ctx), jdn.context_split(rctx)):
        close(a, b, 1e-4)


@torch.no_grad()
def test_update_module(droid):
    """UpdateModule: per-edge outputs, and GraphAgg's per-frame mean at the
    distinct source frames (the JAX module returns every frame slot)."""
    params, model = droid
    rng = np.random.RandomState(5)
    E, h, w = 4, 6, 8
    net = np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, h, w, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(E, h, w, 196)).astype(np.float32)
    flow = rng.normal(size=(E, h, w, 4)).astype(np.float32)
    ii = np.array([2, 0, 2, 3])
    ref = jdn.apply_update(params, J(net), J(inp), J(corr), J(flow),
                           J(ii.astype(np.int32)), 5)
    out = model.update(T(net), T(inp), T(corr), T(flow), T(ii))
    for a, b in zip(out[:3], ref[:3]):
        close(a, b, 1e-4)
    frames = out[3].numpy()
    np.testing.assert_array_equal(frames, [0, 2, 3])
    close(out[4], np.asarray(ref[3])[frames], 1e-4)
    close(out[5], np.asarray(ref[4])[frames], 1e-4)


@torch.no_grad()
def test_convolutions_pin_float32(droid, monkeypatch):
    """Every convolution of the encoders, the update operator, the SSIM blur
    and the image gradients runs with cuDNN's TF32 off (PyTorch's default
    is on); the caller's setting is back afterwards."""
    from wildgs_slam_tpu_torch.ops import ssim as tssim
    from wildgs_slam_tpu_torch.slam import losses as tlosses

    _, model = droid
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*a, **k)
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.RandomState(7)
    img = T(rng.uniform(size=(1, 16, 16, 3)).astype(np.float32))
    model.fnet(img)
    model.cnet(img)
    E, h, w = 2, 2, 2
    model.update(*(T(rng.normal(size=(E, h, w, c)).astype(np.float32))
                   for c in (128, 128, 196, 4)), T(np.array([0, 1])))
    tssim.ssim(img[0], img[0])
    tlosses.image_gradient(img[0, ..., 0])
    tlosses.image_gradient_mask(img[0, ..., 0])
    assert len(seen) > 40 and not any(seen)
    assert torch.backends.cudnn.allow_tf32 is True


def test_cvx_upsample():
    rng = np.random.RandomState(6)
    disp = rng.uniform(0.2, 1.0, size=(2, 6, 8)).astype(np.float32)
    mask = rng.normal(size=(2, 6, 8, 576)).astype(np.float32)
    close(tdn.upsample_disp(T(disp), T(mask)),
          jdn.upsample_disp(J(disp), J(mask)), 1e-6)


# ---------------------------------------------------------------------------
# conv_nhwc: the update operator's convolutions (plain path)
# ---------------------------------------------------------------------------

CONV_EPILOGUES = ["bias", "glo", "relu", "sigmoid", "tanh", "mul", "blend"]


def _nchw_ref(srcs, conv, scale=None):
    """nn.Conv2d on NCHW of the concatenated sources -> NHWC."""
    xs = list(srcs)
    if scale is not None:
        xs[0] = xs[0] * scale
    x = torch.cat(xs, -1).permute(0, 3, 1, 2)
    return conv(x).permute(0, 2, 3, 1)


@torch.no_grad()
@pytest.mark.parametrize("epilogue", CONV_EPILOGUES)
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("channels", [(12,), (8, 196, 4)])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_nhwc_plain_matches_conv2d(k, channels, scaled, epilogue):
    """The wrapper on CPU tensors (its plain version) equals nn.Conv2d on
    NCHW for single- and multi-source inputs, with and without source 0's
    multiplier, and each epilogue; 1e-6 (the same float32 convolution)."""
    from wildgs_slam_tpu_torch.ops import conv_nhwc as cn

    g = torch.Generator().manual_seed(k * 100 + len(channels))
    E, h, w, n = 3, 5, 7, 6
    srcs = [torch.randn(E, h, w, c, generator=g) for c in channels]
    conv = torch.nn.Conv2d(sum(channels), n, k, padding=k // 2)
    conv.bias.normal_(generator=g)
    scale = (torch.rand(E, h, w, channels[0], generator=g) if scaled
             else None)
    ref = _nchw_ref(srcs, conv, scale)
    kw, act = {}, "none"
    if epilogue == "glo":
        kw["glo"] = torch.randn(E, 2 * n, generator=g)[:, n:]   # strided
        ref = ref + kw["glo"][:, None, None, :]
    elif epilogue in ("relu", "sigmoid", "tanh"):
        act = epilogue
        ref = {"relu": torch.relu, "sigmoid": torch.sigmoid,
               "tanh": torch.tanh}[act](ref)
    elif epilogue == "mul":
        kw["mul"] = torch.randn(E, h, w, n, generator=g)
        ref = ref * kw["mul"]
    elif epilogue == "blend":
        act = "tanh"
        hz = torch.randn(E, h, w, n, generator=g)
        z = torch.rand(E, h, w, 2 * n, generator=g)[..., :n]     # a slice
        kw["blend"] = (hz, z)
        ref = (1 - z) * hz + z * torch.tanh(ref)
    out = cn.conv_nhwc(srcs if len(srcs) > 1 else srcs[0], cn.pack(conv),
                       act, scale=scale, **kw)
    assert out.shape == (E, h, w, n) and out.is_contiguous()
    close(out, ref, 1e-6)


@torch.no_grad()
def test_fused_gru_matches_convgru_arithmetic(droid):
    """ConvGRU (NHWC; z|r in one call, q with r * net and the blend in its
    epilogue) against the arithmetic it replaced (NCHW, concatenated
    inputs, separate convolutions), within 1e-6."""
    _, model = droid
    gru = model.update.gru
    rng = np.random.RandomState(11)
    E, h, w = 3, 6, 8
    net = T(np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32))
    xs = [T(rng.normal(size=(E, h, w, c)).astype(np.float32))
          for c in (128, 128, 64)]
    n_ = net.permute(0, 3, 1, 2)
    x_ = torch.cat(xs, -1).permute(0, 3, 1, 2)
    net_inp = torch.cat([n_, x_], 1)
    glo = (torch.sigmoid(gru.w(n_)) * n_).mean(dim=(2, 3), keepdim=True)
    z = torch.sigmoid(gru.convz(net_inp) + gru.convz_glo(glo))
    r = torch.sigmoid(gru.convr(net_inp) + gru.convr_glo(glo))
    q = torch.tanh(gru.convq(torch.cat([r * n_, x_], 1)) + gru.convq_glo(glo))
    ref = ((1 - z) * n_ + z * q).permute(0, 2, 3, 1)
    close(gru(net, xs), ref, 1e-6)


@pytest.mark.parametrize("m,n,want", [
    (64 * 3072, 256, 0), (64 * 3072, 128, 0), (64 * 3072, 64, 1),
    (64 * 3072, 2, 2), (8 * 3600, 256, 0), (3072, 256, 3), (3072, 128, 3),
    (3072, 64, 4), (3072, 1, 2), (2 * 3072, 256, 3), (3 * 3072, 256, 0),
    (64, 384, 3)])
def test_conv_nhwc_plan_follows_shape(m, n, want):
    """The tile follows N (128 wide above 64 channels, the narrow tile for
    the 1- and 2-channel heads) and turns 32 rows high where 128 rows would
    give fewer blocks than the card has SMs: not at the frontend's 64
    edges, but for one edge (M = 3,072). The card here has 132 SMs, as an
    H100 SXM."""
    from wildgs_slam_tpu_torch.ops import conv_nhwc as cn

    assert cn.plan(m, n, 132) == want


@torch.no_grad()
def test_conv_nhwc_packs_follow_parameters(droid):
    """The packed weights are rebuilt when a parameter is written in place
    (load_state_dict): the update equals a fresh module's."""
    _, model = droid
    rng = np.random.RandomState(12)
    E, h, w = 2, 4, 5
    args = [T(rng.normal(size=(E, h, w, c)).astype(np.float32))
            for c in (128, 128, 196, 4)] + [torch.tensor([0, 1])]
    fresh = tdn.DroidNet().eval()
    scratch = tdn.DroidNet().eval()
    scratch.update(*args)                      # packs the old weights
    scratch.load_state_dict(model.state_dict())
    fresh.load_state_dict(model.state_dict())
    for a, b in zip(scratch.update(*args), fresh.update(*args)):
        close(a, b, 0.0)


def test_conv_nhwc_checks_inputs():
    """Channels that are not contiguous, a dtype other than float32, a
    weight of the wrong input width and unaligned slices raise."""
    from wildgs_slam_tpu_torch.ops import conv_nhwc as cn

    conv = cn.pack(torch.nn.Conv2d(8, 4, 3, padding=1))
    x = torch.randn(2, 5, 6, 8)
    assert cn.conv_nhwc(x, conv).shape == (2, 5, 6, 4)
    for bad in (x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                x.double(), torch.randn(2, 5, 6, 12)[..., 2:10]):
        with pytest.raises(ValueError):
            cn.conv_nhwc(bad, conv)
    with pytest.raises(ValueError):
        cn.conv_nhwc(torch.randn(2, 5, 6, 4), conv)
    with pytest.raises(ValueError):
        cn.conv_nhwc(x, conv, "gelu")


# ---------------------------------------------------------------------------
# dba
# ---------------------------------------------------------------------------

def _ba_scene(sensor):
    """5 frames, 12 edges (two inside-window sources with several edges),
    targets = true reprojection + noise, random confidences."""
    rng = np.random.RandomState(7)
    F, h, w = 5, 6, 8
    poses = rand_poses(rng, F, rot=0.03, trans=0.05)
    poses[0] = [0, 0, 0, 0, 0, 0, 1]
    disps = (0.4 + 0.2 * rng.uniform(size=(F, h, w))).astype(np.float32)
    intr = np.array([6.0, 6.0, w / 2, h / 2], np.float32)
    ii = np.array([0, 1, 1, 2, 2, 2, 3, 3, 4, 4, 1, 0])
    jj = np.array([1, 0, 2, 1, 3, 4, 2, 4, 3, 2, 3, 2])
    tgt, _ = jproj.projective_transform(J(poses), J(disps), J(intr), J(ii),
                                        J(jj))
    tgt = (np.asarray(tgt) + 0.3 * rng.normal(size=tgt.shape)).astype(
        np.float32)
    wgt = rng.uniform(0.1, 1.0, size=tgt.shape).astype(np.float32)
    eta = rng.uniform(1e-3, 1e-2, size=(F, h, w)).astype(np.float32)
    # BA starts from perturbed poses and disparities
    poses0 = np.asarray(jlie.se3_retr(J(poses), J(
        0.01 * rng.normal(size=(F, 6)).astype(np.float32))))
    disps0 = (disps * (1 + 0.05 * rng.normal(size=disps.shape))).astype(
        np.float32)
    sens = None
    if sensor:
        sdisp = (disps * (1 + 0.01 * rng.normal(size=disps.shape))).astype(
            np.float32)
        svalid = rng.uniform(size=disps.shape) > 0.2
        sens = (sdisp, svalid)
    return poses0, disps0, intr, tgt, wgt, eta, ii, jj, sens


@pytest.mark.parametrize("sensor", [False, True])
@pytest.mark.parametrize("motion_only", [False, True])
def test_ba(sensor, motion_only):
    poses, disps, intr, tgt, wgt, eta, ii, jj, sens = _ba_scene(sensor)
    F_ = poses.shape[0]
    t0, t1 = 1, F_
    groups = jdba.make_edge_groups(ii, F_, 16)
    jkw = tkw = {}
    if sens is not None:
        jkw = dict(sensor_disps=J(sens[0]), sensor_valid=J(sens[1]))
        tkw = dict(sensor_disps=T(sens[0]), sensor_valid=T(sens[1]))
    rp, rd = jdba.ba(J(poses), J(disps), J(intr), J(tgt), J(wgt), J(eta),
                     J(ii), J(jj), jnp.ones(len(ii), bool), J(groups), t0, t1,
                     iters=2, motion_only=motion_only, pmax=F_, **jkw)
    tp, td = tdba.ba(T(poses), T(disps), T(intr), T(tgt), T(wgt), T(eta),
                     T(ii), T(jj), tdba.make_edge_groups(ii, F_, 16), t0, t1,
                     iters=2, motion_only=motion_only, **tkw)
    rp, rd = np.asarray(rp), np.asarray(rd)
    assert np.abs(rp - poses).max() > 1e-3       # the solve moved the poses
    assert np.abs(tp.numpy() - rp).max() / np.abs(rp).max() < 1e-5
    assert np.abs(td.numpy() - rd).max() / np.abs(rd).max() < 1e-4
    np.testing.assert_array_equal(tp.numpy()[0], poses[0])   # fixed frame


def test_frame_distance():
    rng = np.random.RandomState(8)
    poses, disps, intr, ii, jj = _geometry(rng, F=5, h=12, w=16)
    intr = intr * 2
    for beta in (0.3, 0.75):
        ref = jdba.frame_distance_bidirectional(J(poses), J(disps), J(intr),
                                                J(ii), J(jj), beta)
        out = tdba.frame_distance_bidirectional(T(poses), T(disps), T(intr),
                                                T(ii), T(jj), beta)
        close(out, ref, 0, rtol=1e-5)
    # < 75% valid pixels -> 1000
    far = poses.copy()
    far[1, :3] = [0, 0, -10.0]
    d = tdba.frame_distance(T(far), T(disps), T(intr), T(np.array([0])),
                            T(np.array([1])))
    assert float(d[0]) == 1000.0


def test_depth_filter_count():
    rng = np.random.RandomState(9)
    F_, h, w = 9, 12, 16
    xi = np.zeros((F_, 6), np.float32)
    xi[:, 0] = 0.02 * np.arange(F_)
    poses = np.asarray(jlie.se3_exp(J(xi)))
    disps = np.tile(0.5 + 0.1 * np.linspace(0, 1, w)[None, None], (F_, h, 1))
    disps = (disps * (1 + 0.02 * rng.normal(size=disps.shape))).astype(
        np.float32)
    intr = np.array([12.0, 12.0, w / 2, h / 2], np.float32)
    index = np.array([0, 2, 4, 8])
    thresh = np.array([0.02, 0.05, 0.1, 0.05], np.float32)
    ref = jdba.depth_filter_count(J(poses), J(disps), J(intr), J(index),
                                  J(thresh))
    out = tdba.depth_filter_count(T(poses), T(disps), T(intr), T(index),
                                  T(thresh))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 0 < out.numpy().mean() < 6


def test_ape_statistics():
    """The port's copy of the trajectory alignment (Sim3 Umeyama)."""
    from wildgs_slam_tpu.utils import eval_traj as jev
    from wildgs_slam_tpu_torch.utils import eval_traj as tev

    rng = np.random.RandomState(10)
    gt = np.cumsum(rng.normal(size=(20, 3)), 0)
    R = np.asarray(jlie.quat_to_matrix(jnp.asarray(
        [0.1, -0.2, 0.3, 0.9]) / np.linalg.norm([0.1, -0.2, 0.3, 0.9])))
    est = 0.5 * gt @ R.T + 1.0 + 0.01 * rng.normal(size=gt.shape)
    ref = jev.ape_statistics(est, gt)
    out = tev.ape_statistics(est, gt)
    for k in ("rmse", "mean", "median", "max", "scale"):
        assert abs(out[k] - ref[k]) < 1e-12, k
    assert out["n"] == ref["n"] == 20
