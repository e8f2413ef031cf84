"""GUI -> SLAM control channel: pause/resume/stop/checkpoint; the port's
own copy of ``wildgs_slam_tpu/gui/control.py`` (standard library only).

The reference viewer steers the SLAM process through `Packet_vis2main`
messages on a multiprocessing queue (src/gui/slam_gui.py:58-782,
gui_utils.py:86-190: flag_pause pauses the mapper's optimization loop).
The single-controller build replaces the queue with a `ControlChannel`
polled by SLAM.run between frames, driven by either side:

  - file commands: write JSON to `<out>/gui/control.json`, e.g.
      {"pause": true}            pause after the current frame
      {"pause": false}           resume
      {"stop": true}             finish the stream early (runs terminate())
      {"save_checkpoint": true}  one-shot mid-run checkpoint
  - HTTP commands (optional `http_port`): GET /pause /resume /stop
    /checkpoint /status — the FileGui index page renders buttons for these,
    making the browser view fully interactive like the reference GUI.

Pausing blocks the tracker loop exactly like the reference's lock-step
pipe rendezvous would (tracker waits while the GUI holds the mapper).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional


class ControlChannel:
    def __init__(self, out_dir: str, http_port: Optional[int] = None):
        self.dir = os.path.join(out_dir, "gui")
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "control.json")
        self._mtime = 0.0
        self._lock = threading.Lock()
        self.state = {"pause": False, "stop": False, "save_checkpoint": False}
        self.http_port = None
        self._server = None
        if http_port is not None:
            self._start_http(http_port)

    # ------------------------------------------------------------------

    def _merge(self, cmd: dict):
        with self._lock:
            for k in self.state:
                if k in cmd:
                    self.state[k] = bool(cmd[k])

    def _poll_file(self):
        try:
            m = os.path.getmtime(self.path)
        except OSError:
            return
        if m <= self._mtime:
            return
        self._mtime = m
        try:
            with open(self.path) as f:
                self._merge(json.load(f))
        except (ValueError, OSError):
            pass  # partially written; picked up on the next poll

    def poll(self) -> dict:
        """Latest command state (reads the control file if it changed)."""
        self._poll_file()
        with self._lock:
            return dict(self.state)

    def consume_checkpoint_request(self) -> bool:
        """One-shot: true if a checkpoint was requested since last call."""
        self.poll()
        with self._lock:
            req = self.state["save_checkpoint"]
            self.state["save_checkpoint"] = False
        return req

    def wait_if_paused(self, on_tick: Callable[[], None] | None = None,
                       interval: float = 0.2):
        """Block while paused (the reference's flag_pause loop,
        mapper.py pause handling). `stop` breaks the wait."""
        while True:
            st = self.poll()
            if not st["pause"] or st["stop"]:
                return
            if on_tick is not None:
                on_tick()
            time.sleep(interval)

    # ------------------------------------------------------------------

    def _start_http(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        chan = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                cmd = self.path.strip("/").split("?")[0]
                if cmd == "pause":
                    chan._merge({"pause": True})
                elif cmd == "resume":
                    chan._merge({"pause": False})
                elif cmd == "stop":
                    chan._merge({"stop": True})
                elif cmd == "checkpoint":
                    chan._merge({"save_checkpoint": True})
                elif cmd not in ("status", ""):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(chan.poll()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.http_port = self._server.server_address[1]  # resolved (port 0)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
