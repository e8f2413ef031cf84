"""File-based live GUI: image panels and an auto-refreshing index page; the
port's own copy of ``wildgs_slam_tpu/gui/file_gui.py``.

The mapper hands a ``GaussianPacket`` to ``FileGui.push`` after each
keyframe; each packet becomes files under ``<out>/gui/`` that a browser
shows live: ``index.html`` (refreshes every 2 s, with the control
channel's buttons when its HTTP port is known), ``render.png`` (the
keyframe and its render side by side), ``depth.png`` (the rendered depth in
plasma), ``uncertainty.png`` (the MLP's uncertainty in jet),
``traj.png`` (the keyframes' camera centres seen from above, x right and z
up), and ``live.html`` with ``map.json``, the orbiting point view of the map.

``index.html``, ``live.html`` and ``map.json`` are the bytes the JAX
package writes. The PNG panels carry the images that matplotlib's
``imshow`` colours there (colour clipped to [0, 1] and scaled to bytes,
scalars normalised from their minimum to their maximum into 256-entry
plasma and jet tables kept here), at the data's own size and without the
figure's frame, axes and title; the trajectory is drawn by the port's own
rasteriser. No matplotlib: the images are written by ``utils/png.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..utils.png import write_png
from .html_viewer import map_snapshot_json, write_live_viewer

_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>wildgs_slam_tpu live</title>
<meta http-equiv="refresh" content="2">
<style>body{background:#111;color:#eee;font-family:monospace}
img{max-width:46vw;margin:4px;border:1px solid #333}
button{background:#333;color:#eee;border:1px solid #666;margin:2px;
padding:4px 10px;cursor:pointer}</style></head>
<body><h3>wildgs_slam_tpu — live view (auto-refresh 2s)</h3>
{controls}
<div><img src="render.png?r={r}"><img src="depth.png?r={r}"></div>
<div><img src="uncertainty.png?r={r}"><img src="traj.png?r={r}"></div>
<p>{status}</p></body></html>
"""

_CONTROLS_HTTP = """<div>
<button onclick="fetch('http://127.0.0.1:{port}/pause')">pause</button>
<button onclick="fetch('http://127.0.0.1:{port}/resume')">resume</button>
<button onclick="fetch('http://127.0.0.1:{port}/checkpoint')">checkpoint</button>
<button onclick="fetch('http://127.0.0.1:{port}/stop')">stop</button>
</div>"""

_CONTROLS_FILE = ("<p>control: write {\"pause\": true} etc. to "
                  "gui/control.json</p>")

# matplotlib's 256-entry colormaps as bytes (cmap(range(256), bytes=True),
# RGB), 3 hex bytes per entry
_LUT_HEX = {
    "plasma": (
        "0c078610078713068915068a18068b1b068c1d068d1f058e21058f230590250591270592"
        "2905932b05942d04942f04953104963304973404983604983804993a049a3b039a3d039b"
        "3f039c40039c42039d44039e45039e47029f49029f4a02a04c02a14e02a14f02a25101a2"
        "5201a35401a35601a35701a45901a45a00a55c00a55e00a55f00a66100a66200a66400a7"
        "6500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500a87601a8"
        "7801a87901a87b02a87c02a77e03a77f03a78104a78204a78405a68506a68607a68807a5"
        "8908a58b09a48c0aa48e0ca48f0da3900ea3920fa29310a19511a19612a09713a099149f"
        "9a159e9b179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
        "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e8cb62f8b"
        "b7308ab83289b93388ba3487bb3586bc3685bd3784be3883bf3982c03b81c13c80c23d80"
        "c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678cb4777cc4876cd4975ce4a75"
        "cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586a"
        "d95969da5a68db5b67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660"
        "e3675fe3685ee46a5de56b5ce56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455"
        "eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4ef0804df0814df1824cf2844b"
        "f2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
        "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436"
        "fca635fca735fca934fcaa33fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62d"
        "fdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328fdc427fdc626fcc726fcc926"
        "fccb25fccc25fcce25fbd024fbd124fbd324fad524fad624fad824f9d924f9db24f8dd24"
        "f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3ee26f2f026f2f126"
        "f1f326f0f525f0f623eff821"),
    "jet": (
        "00007f00008400008800008d00009100009600009a00009f0000a30000a80000ac0000b1"
        "0000b60000ba0000bf0000c30000c80000cc0000d10000d50000da0000de0000e30000e8"
        "0000ec0000f10000f50000fa0000fe0000ff0000ff0000ff0000ff0004ff0008ff000cff"
        "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
        "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
        "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
        "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
        "00d0ff00d4ff00d8ff00dcfe00e0fa00e4f702e8f405ecf108f0ed0cf4ea0ff8e712fce4"
        "15ffe118ffdd1cffda1fffd722ffd425ffd029ffcd2cffca2fffc732ffc336ffc039ffbd"
        "3cffba3fffb742ffb346ffb049ffad4cffaa4fffa653ffa356ffa059ff9d5cff9a5fff96"
        "63ff9366ff9069ff8d6cff8970ff8673ff8376ff8079ff7d7cff7980ff7683ff7386ff70"
        "89ff6c8dff6990ff6693ff6396ff5f9aff5c9dff59a0ff56a3ff53a6ff4faaff4cadff49"
        "b0ff46b3ff42b7ff3fbaff3cbdff39c0ff36c3ff32c7ff2fcaff2ccdff29d0ff25d4ff22"
        "d7ff1fdaff1cddff18e0ff15e4ff12e7ff0feaff0cedff08f1fc05f4f802f7f400faf000"
        "feed00ffe900ffe500ffe200ffde00ffda00ffd700ffd300ffcf00ffcb00ffc800ffc400"
        "ffc000ffbd00ffb900ffb500ffb100ffae00ffaa00ffa600ffa300ff9f00ff9b00ff9800"
        "ff9400ff9000ff8c00ff8900ff8500ff8100ff7e00ff7a00ff7600ff7300ff6f00ff6b00"
        "ff6700ff6400ff6000ff5c00ff5900ff5500ff5100ff4d00ff4a00ff4600ff4200ff3f00"
        "ff3b00ff3700ff3400ff3000ff2c00ff2800ff2500ff2100ff1d00ff1a00ff1600fe1200"
        "fa0f00f50b00f10700ec0300e80000e30000de0000da0000d50000d10000cc0000c80000"
        "c30000bf0000ba0000b60000b10000ac0000a80000a300009f00009a0000960000910000"
        "8d00008800008400007f0000"),
}
LUTS = {name: np.frombuffer(bytes.fromhex(h), np.uint8).reshape(256, 3)
        for name, h in _LUT_HEX.items()}
TRAJ_HW = (480, 640)          # the trajectory panel's size
TRAJ_LINE = (0, 191, 191)     # matplotlib's "c"
TRAJ_LAST = (255, 0, 0)       # matplotlib's "r"


@dataclass
class GaussianPacket:
    """Snapshot handed from the mapper to the GUI."""

    frame_idx: int
    gt_color: np.ndarray                       # (H, W, 3)
    rendered_color: np.ndarray                 # (H, W, 3)
    rendered_depth: np.ndarray                 # (H, W)
    uncertainty: Optional[np.ndarray] = None   # (h', w')
    traj_xyz: Optional[np.ndarray] = None      # (N, 3) keyframe centers
    window: list = field(default_factory=list)
    n_gaussians: int = 0
    # live 3D map snapshot (downsampled; drives gui/live.html)
    map_xyz: Optional[np.ndarray] = None       # (M, 3)
    map_rgb: Optional[np.ndarray] = None       # (M, 3) in [0,1]
    map_scale: Optional[np.ndarray] = None     # (M,)


def colour_bytes(rgb) -> np.ndarray:
    """imshow's bytes of a float RGB image: clipped to [0, 1], x 255,
    truncated."""
    return (np.clip(np.asarray(rgb, np.float32), 0, 1) * 255).astype(np.uint8)


def colormap_bytes(a, name: str) -> np.ndarray:
    """imshow's bytes of a scalar image under the named colormap, normalised
    from its minimum to its maximum (matplotlib's Normalize in float32, then
    256 bins with 1.0 in the last)."""
    a = np.asarray(a, np.float32)
    lo, hi = a.min(), a.max()
    x = (np.zeros_like(a) if lo == hi else (a - lo) / (hi - lo)) * 256
    idx = np.where(x == 256, 255, x).astype(np.int64)
    return LUTS[name][idx]


def trajectory_panel(xyz, hw=TRAJ_HW) -> np.ndarray:
    """The camera centres' (x, z) on a white panel, equal aspect, joined in
    order by a cyan line with a dot at each, the last one marked red."""
    h, w = hw
    img = np.full((h, w, 3), 255, np.uint8)
    xz = np.asarray(xyz, np.float64)[:, [0, 2]]
    lo, hi = xz.min(0), xz.max(0)
    s = 0.9 * min(h, w) / max(float((hi - lo).max()), 1e-9)
    pts = np.stack([w / 2 + (xz[:, 0] - (lo[0] + hi[0]) / 2) * s,
                    h / 2 - (xz[:, 1] - (lo[1] + hi[1]) / 2) * s], -1)

    def put(p, colour, r=0):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                x = np.clip(np.round(p[:, 0]).astype(int) + dx, 0, w - 1)
                y = np.clip(np.round(p[:, 1]).astype(int) + dy, 0, h - 1)
                img[y, x] = colour
    for a, b in zip(pts[:-1], pts[1:]):
        t = np.linspace(0.0, 1.0, int(np.abs(b - a).max()) + 2)[:, None]
        put(a + t * (b - a), TRAJ_LINE)
    put(pts, TRAJ_LINE, 1)
    put(pts[-1:], TRAJ_LAST, 3)
    return img


class FileGui:
    def __init__(self, out_dir: str, http_port: Optional[int] = None):
        self.dir = os.path.join(out_dir, "gui")
        os.makedirs(self.dir, exist_ok=True)
        self._rev = 0
        self.http_port = http_port

    def push(self, pkt: GaussianPacket):
        def save(name, img):
            write_png(os.path.join(self.dir, name), img)

        save("render.png", colour_bytes(np.concatenate(
            [pkt.gt_color, pkt.rendered_color], axis=1)))
        save("depth.png", colormap_bytes(pkt.rendered_depth, "plasma"))
        if pkt.uncertainty is not None:
            save("uncertainty.png", colormap_bytes(pkt.uncertainty, "jet"))
        if pkt.traj_xyz is not None and len(pkt.traj_xyz):
            save("traj.png", trajectory_panel(pkt.traj_xyz))

        self._rev += 1
        if pkt.map_xyz is not None and len(pkt.map_xyz):
            live = os.path.join(self.dir, "live.html")
            if not os.path.exists(live):
                write_live_viewer(live, http_port=self.http_port)
            with open(os.path.join(self.dir, "map.json"), "w") as f:
                f.write(map_snapshot_json(pkt.map_xyz, pkt.map_rgb,
                                          pkt.map_scale, pkt.frame_idx,
                                          self._rev))
        status = (f"frame {pkt.frame_idx} · window {pkt.window} · "
                  f"{pkt.n_gaussians} gaussians · "
                  f"<a href='live.html' style='color:#6cf'>live 3D map</a>")
        controls = (_CONTROLS_HTTP.replace("{port}", str(self.http_port))
                    if self.http_port else _CONTROLS_FILE)
        with open(os.path.join(self.dir, "index.html"), "w") as f:
            f.write(_INDEX_HTML.replace("{r}", str(self._rev))
                    .replace("{status}", status)
                    .replace("{controls}", controls))
