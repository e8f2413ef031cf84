"""Colored per-subsystem logging + progress; the port's own copy of
``wildgs_slam_tpu/utils/printer.py`` (port of src/utils/Printer.py).

The reference runs a dedicated printing process fed by an mp.Queue
(Printer.py:44-95) because its tracker/mapper are separate processes; in the
single-controller design a plain object with the same color-tag API and an
optional tqdm progress bar suffices.
"""

from __future__ import annotations

import sys
import time


class FontColor:
    TRACKER = "\033[94m"     # blue
    MAPPER = "\033[92m"      # green
    EVAL = "\033[95m"        # magenta
    INFO = "\033[96m"        # cyan
    ERROR = "\033[91m"       # red
    PCL = "\033[93m"         # yellow
    _RESET = "\033[0m"

    _TAGS = {
        TRACKER: "[TRACKER]",
        MAPPER: "[MAPPER ]",
        EVAL: "[EVAL   ]",
        INFO: "[INFO   ]",
        ERROR: "[ERROR  ]",
        PCL: "[PCD    ]",
    }


class Printer:
    def __init__(self, total_frames: int = 0, verbose: bool = True,
                 use_color: bool = True):
        self.verbose = verbose
        self.use_color = use_color and sys.stdout.isatty()
        self.total = total_frames
        self.count = 0
        self._t0 = time.time()
        self._pbar = None

    def configure(self, total_frames=None, verbose=None):
        """Late configuration of the shared instance (the frame count is
        only known once SLAM.run sees the stream)."""
        if total_frames is not None:
            self.total = total_frames
            if self._pbar is not None:
                self._pbar.total = total_frames
        if verbose is not None:
            self.verbose = verbose
        self.count = 0
        self._t0 = time.time()

    def print(self, msg, color=FontColor.INFO):
        if not self.verbose and color is not FontColor.ERROR:
            return  # errors/warnings always surface (plain print() did)
        tag = FontColor._TAGS.get(color, "[INFO   ]")
        if self.use_color:
            print(f"{color}{tag}{FontColor._RESET} {msg}", flush=True)
        else:
            print(f"{tag} {msg}", flush=True)

    def pbar_ready(self):
        try:
            from tqdm import tqdm

            self._pbar = tqdm(total=self.total, desc="frames", ncols=80)
        except Exception:
            self._pbar = None

    def update_pbar(self, n=1):
        self.count += n
        if self._pbar is not None:
            self._pbar.update(n)

    def terminate(self):
        if self._pbar is not None:
            self._pbar.close()
            self._pbar = None
        self.print(f"finished {self.count} frames in "
                   f"{time.time() - self._t0:.1f}s", FontColor.INFO)


# Shared instance: the reference funnels every subsystem's output through one
# Printer process (src/slam.py:33, passed to tracker/mapper/backend/eval);
# the single-controller equivalent is one shared object.
PRINTER = Printer()
