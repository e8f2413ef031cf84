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
``load_state_dict``. Convolutions run NCHW inside; the public functions
keep the JAX package's NHWC layout. Every padding mirrors the flax
module's: explicit 1 (3x3), 3 (7x7), none for 1x1 ('SAME' at stride 1, and
at stride 2 on an even input). The gradient clip of the JAX heads is the
identity in the forward pass and is not carried: the port does not train
this network. Compute is float32, the JAX package's non-TPU choice: the
encoders and the update operator pin cuDNN to float32 themselves
(``utils.precision.float32_convs``).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..utils.precision import float32_convs


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
        """NCHW net (N, 128, H, W) and concatenated inputs."""
        net_inp = torch.cat([net, inp], dim=1)
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 128, 3, padding=1)
        self.eta = nn.Sequential(nn.Conv2d(128, 1, 3, padding=1))
        self.upmask = nn.Sequential(nn.Conv2d(128, 8 * 8 * 9, 1))

    def forward(self, net, ii):
        """NCHW net (E, 128, H, W), ii (E,) source frame of each edge ->
        (frames (U,) the sorted distinct source frames, eta (U, H, W),
        upmask (U, 576, H, W)): the mean over each frame's edges, then the
        damping and mask heads."""
        frames, inv = torch.unique(ii, return_inverse=True)
        h = F.relu(self.conv1(net))
        sums = torch.zeros((frames.shape[0],) + h.shape[1:], dtype=h.dtype,
                           device=h.device).index_add_(0, inv, h)
        counts = torch.bincount(inv, minlength=frames.shape[0]).to(h.dtype)
        h = sums / torch.clamp(counts, min=1.0)[:, None, None, None]
        h = F.relu(self.conv2(h))
        eta = F.softplus(self.eta(h))[:, 0]
        return frames, 0.01 * eta, self.upmask(h)


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

    @float32_convs()
    def forward(self, net, inp, corr, flow, ii):
        """NHWC net/inp (E, H, W, 128), corr (E, H, W, 196), flow
        (E, H, W, 4), ii (E,) -> net (E, H, W, 128), delta and weight
        (E, H, W, 2), and per distinct source frame: frames (U,), eta
        (U, H, W), upmask (U, H, W, 576)."""
        net = _nchw(net)
        c = self.corr_encoder(_nchw(corr))
        f = self.flow_encoder(_nchw(flow))
        net = self.gru(net, torch.cat([_nchw(inp), c, f], dim=1))
        delta = self.delta(net)
        weight = torch.sigmoid(self.weight(net))
        frames, eta, upmask = self.agg(net, ii)
        return (_nhwc(net).contiguous(), _nhwc(delta).contiguous(),
                _nhwc(weight).contiguous(), frames, eta,
                _nhwc(upmask).contiguous())


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
