"""DROID-SLAM recurrent update network; torch port of
``wildgs_slam_tpu/models/droid_net.py``.

- ``BasicEncoder``: the 1/8-resolution residual CNN, as ``fnet`` (128
  channels, instance norm) and ``cnet`` (256 channels, no norm);
- ``ConvGRU`` with the global-context gate;
- ``UpdateModule``: correlation and flow encoders, the GRU, the 2-channel
  delta and weight heads (trimmed as the JAX package and upstream's
  ``slam.py`` trim them) and ``GraphAgg``, the per-source-frame damping and
  upsampling-mask head;
- ``cvx_upsample`` / ``upsample_disp``: softmax-convex 8x upsampling.

Submodules carry upstream's ``droid.pth`` names (``fnet.layer2.0.
downsample.0``, ``update.corr_encoder.0``, ``update.gru.convz``,
``update.agg.eta.0``, ...), so a converted checkpoint loads with
``load_state_dict``. The encoders convolve NCHW inside (cuDNN); the update
operator's convolutions run NHWC through ``ops/conv_nhwc.py`` (on the card
its kernel, with the GRU's concatenations, ``r * net``, the global-context
terms and the state blend fused; ``convz|convr`` and ``delta.0|weight.0|
agg.conv1`` one launch each), and each launch there adds to ``TIMER``'s
counter ``track.upd.kernel_convs``. The public functions keep the JAX
package's NHWC layout. Every padding mirrors the flax module's: explicit 1
(3x3), 3 (7x7), none for 1x1 ('SAME' at stride 1, and at stride 2 on an
even input). The gradient clip of the JAX heads is the identity in the
forward pass and is not carried: the port does not train this network.
Compute is float32, the JAX package's non-TPU choice: the encoders and the
update operator's plain path pin cuDNN to float32 themselves
(``utils.precision.float32_convs``).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.conv_nhwc import conv_nhwc, packs
from ..utils.precision import float32_convs
from ..utils.profiling import TIMER


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters, on NCHW."""
    return F.instance_norm(x, eps=eps)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "none",
                 stride: int = 1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = (nn.Sequential(nn.Conv2d(in_planes, planes, 1,
                                                   stride=stride))
                           if stride > 1 else None)

    def _norm(self, y):
        return instance_norm(y) if self.norm_fn == "instance" else y

    def forward(self, x):
        y = F.relu(self._norm(self.conv1(x)))
        y = F.relu(self._norm(self.conv2(y)))
        if self.downsample is not None:
            x = self._norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, out_dim: int, norm_fn: str = "none", dim: int = 32):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(3, dim, 7, stride=2, padding=3)
        planes = [(dim, dim, 1), (dim, 2 * dim, 2), (2 * dim, 4 * dim, 2)]
        for li, (cin, cout, stride) in enumerate(planes, start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                ResidualBlock(cin, cout, norm_fn, stride),
                ResidualBlock(cout, cout, norm_fn, 1)))
        self.conv2 = nn.Conv2d(4 * dim, out_dim, 1)

    @float32_convs()
    def forward(self, x):
        """x (N, H, W, 3) -> (N, H/8, W/8, out_dim)."""
        h = self.conv1(_nchw(x))
        if self.norm_fn == "instance":
            h = instance_norm(h)
        h = F.relu(h)
        h = self.layer3(self.layer2(self.layer1(h)))
        return _nhwc(self.conv2(h)).contiguous()


def _conv(srcs, packed, act="none", **epilogue):
    """One convolution of the update operator, NHWC (``conv_nhwc``); each
    launch of the kernel adds to the counter ``track.upd.kernel_convs``."""
    out = conv_nhwc(srcs, packed, act, **epilogue)
    if out.is_cuda:
        TIMER.count("track.upd.kernel_convs")
    return out


class ConvGRU(nn.Module):
    def __init__(self, h_planes: int = 128, i_planes: int = 320):
        super().__init__()
        hi = h_planes + i_planes
        self.convz = nn.Conv2d(hi, h_planes, 3, padding=1)
        self.convr = nn.Conv2d(hi, h_planes, 3, padding=1)
        self.convq = nn.Conv2d(hi, h_planes, 3, padding=1)
        self.w = nn.Conv2d(h_planes, h_planes, 1)
        self.convz_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convr_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convq_glo = nn.Conv2d(h_planes, h_planes, 1)

    def forward(self, net, inp):
        """NHWC net (E, H, W, 128) and inp, a sequence of NHWC inputs whose
        channels follow net's (the context, correlation and flow features)
        -> the new net. Four launches: sigmoid(w(net)) * net; the three
        global-context terms; z|r; q with r * net and the blend."""
        p = packs(self, {"w": (self.w,), "zr": (self.convz, self.convr),
                         "q": (self.convq,),
                         "glo": (self.convz_glo, self.convr_glo,
                                 self.convq_glo)})
        nh = net.shape[-1]
        srcs = (net, *inp)
        glo = _conv(net, p["w"], "sigmoid", mul=net).mean(dim=(1, 2),
                                                          keepdim=True)
        glo = _conv(glo, p["glo"]).reshape(net.shape[0], 3 * nh)
        zr = _conv(srcs, p["zr"], "sigmoid", glo=glo[:, :2 * nh])
        return _conv(srcs, p["q"], "tanh", glo=glo[:, 2 * nh:],
                     scale=zr[..., nh:], blend=(net, zr[..., :nh]))


class GraphAgg(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 128, 3, padding=1)
        self.eta = nn.Sequential(nn.Conv2d(128, 1, 3, padding=1))
        self.upmask = nn.Sequential(nn.Conv2d(128, 8 * 8 * 9, 1))

    def forward(self, h, ii):
        """NHWC h (E, H, W, 128) = relu(conv1(net)) of each edge (the update
        module runs conv1 in one launch with its heads), ii (E,) source frame
        of each edge -> (frames (U,) the sorted distinct source frames, eta
        (U, H, W), upmask (U, H, W, 576)): the mean over each frame's edges,
        then the damping and mask heads."""
        p = packs(self, {"conv2": (self.conv2,), "eta": (self.eta[0],),
                         "upmask": (self.upmask[0],)})
        frames, inv = torch.unique(ii, return_inverse=True)
        sums = torch.zeros((frames.shape[0],) + h.shape[1:], dtype=h.dtype,
                           device=h.device).index_add_(0, inv, h)
        counts = torch.bincount(inv, minlength=frames.shape[0]).to(h.dtype)
        h = _conv(sums / torch.clamp(counts, min=1.0)[:, None, None, None],
                  p["conv2"], "relu")
        eta = F.softplus(_conv(h, p["eta"]))[..., 0]
        return frames, 0.01 * eta, _conv(h, p["upmask"])


class UpdateModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(196, 128, 1), nn.ReLU(inplace=True),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(inplace=True))
        self.flow_encoder = nn.Sequential(
            nn.Conv2d(4, 128, 7, padding=3), nn.ReLU(inplace=True),
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU(inplace=True))
        self.weight = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(128, 2, 3, padding=1))
        self.delta = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(128, 2, 3, padding=1))
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow, ii):
        """NHWC net/inp (E, H, W, 128), corr (E, H, W, 196), flow
        (E, H, W, 4), ii (E,) -> net (E, H, W, 128), delta and weight
        (E, H, W, 2), and per distinct source frame: frames (U,), eta
        (U, H, W), upmask (U, H, W, 576)."""
        p = packs(self, {
            "corr0": (self.corr_encoder[0],), "corr2": (self.corr_encoder[2],),
            "flow0": (self.flow_encoder[0],), "flow2": (self.flow_encoder[2],),
            "heads": (self.delta[0], self.weight[0], self.agg.conv1),
            "delta": (self.delta[2],), "weight": (self.weight[2],)})
        net, inp, corr, flow = (x.contiguous() for x in (net, inp, corr, flow))
        c = _conv(_conv(corr, p["corr0"], "relu"), p["corr2"], "relu")
        f = _conv(_conv(flow, p["flow0"], "relu"), p["flow2"], "relu")
        net = self.gru(net, (inp, c, f))
        nh = net.shape[-1]
        heads = _conv(net, p["heads"], "relu")   # delta.0 | weight.0 | conv1
        delta = _conv(heads[..., :nh], p["delta"])
        weight = _conv(heads[..., nh:2 * nh], p["weight"], "sigmoid")
        frames, eta, upmask = self.agg(heads[..., 2 * nh:], ii)
        return net, delta, weight, frames, eta, upmask


class DroidNet(nn.Module):
    """fnet / cnet / update bundle."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(128, "instance")
        self.cnet = BasicEncoder(256, "none")
        self.update = UpdateModule()


@torch.no_grad()
def init_droid_net(generator: torch.Generator, device="cuda") -> DroidNet:
    """A DroidNet with flax's default initialisation (lecun-normal kernels
    truncated at 2σ, zero biases), drawn from `generator`; the shapes are
    those of ``droid.pth`` with the trimmed heads."""
    net = DroidNet()
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
    return net.to(device).eval()


HEADS = ("update.weight.2", "update.delta.2")   # trimmed to 2 channels


@torch.no_grad()
def load_droid_checkpoint(path: str, device="cuda") -> DroidNet:
    """A DroidNet from upstream's ``droid.pth``: the ``module.`` prefix
    stripped, the weight and delta heads trimmed to their first 2 output
    channels (as upstream's slam.py and the JAX loader do)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k.replace("module.", ""): v.float() for k, v in state.items()}
    for head in HEADS:
        for leaf in ("weight", "bias"):
            state[f"{head}.{leaf}"] = state[f"{head}.{leaf}"][:2]
    net = DroidNet()
    net.load_state_dict(state)
    return net.to(device).eval()


def context_split(context):
    """cnet output (N, H, W, 256) -> (net, inp) = (tanh, relu) halves."""
    net, inp = context.split(context.shape[-1] // 2, dim=-1)
    return torch.tanh(net), F.relu(inp)


def motion_features(coords0, coords1, target):
    """The update operator's motion input (E, h, w, 4): flow and residual."""
    return torch.clamp(torch.cat([coords1 - coords0, target - coords1], -1),
                       -64.0, 64.0)


def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """data (B, H, W, D), mask (B, H, W, 576) -> (B, 8H, 8W, D)."""
    B, H, W, D = data.shape
    m = torch.softmax(mask.reshape(B, H, W, 9, 8, 8), dim=3)
    pad = F.pad(data, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pad[:, dy:dy + H, dx:dx + W]
                         for dy in range(3) for dx in range(3)], dim=3)
    up = torch.einsum("bhwkij,bhwkd->bhwijd", m, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * H, 8 * W, D)


def upsample_disp(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """disp (B, H, W) + mask (B, H, W, 576) -> (B, 8H, 8W)."""
    return cvx_upsample(disp[..., None], mask)[..., 0]
