"""The control channel, the file GUI and the map's HTML viewers; the port's
own copies of ``wildgs_slam_tpu/gui/``."""

from .file_gui import FileGui, GaussianPacket

__all__ = ["FileGui", "GaussianPacket"]
