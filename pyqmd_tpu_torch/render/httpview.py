"""Browser live view: the graphical window of a machine without a display.

The reference displays through an in-process PyGame window with keyboard
controls (nuclear_sim.py:33-35, 381-521, 589-606). A compute host has no
window, so this module serves the same live view over HTTP to any browser,
with the standard library only:

* ``/``        — control page: live <img> stream, status readout, and the
  reference's control surface (force decay, time-scale steps/presets,
  zoom, isotope selection — nuclear_sim.py:430-521 keymap semantics) as
  buttons hitting the endpoints below.
* ``/stream``  — ``multipart/x-mixed-replace`` PNG stream; each part is a
  freshly simulated + rendered frame with the burned-in info and
  decay-chain panels (the reference draws both every frame,
  rendering.py:135-380).
* ``/frame``   — one PNG frame (for curl / tests / screenshots).
* ``/status``  — the info-panel data as JSON.
* ``/control`` — query-string controls: ``?do=decay|faster|slower|
  bigger|smaller|zoomin|zoomout`` / ``?preset=year`` / ``?iso=U-238``.

Single simulation, many possible viewers: every handler serializes on
one lock around the ``Simulation``, and all stream connections share
ONE stepping cadence through :meth:`LiveViewServer.pump_frame` — the
reference has one window, so N open tabs must see the SAME frames, not
advance simulated time N times faster. Controls mutate host-side
scheduling state only. Binds 127.0.0.1 by default — this is a local
viewer, not a public service.

Each request runs on a thread of its own. CUDA's current device belongs to
the thread, so everything that touches the simulation runs with the
simulation's device made current (:meth:`LiveViewServer._sim_device`); the
work goes to that device's default stream, which all threads share, so a
frame stepped by one handler and a status read by another stay ordered.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

logger = logging.getLogger("pyqmd_tpu_torch")

_PAGE = """<!doctype html>
<html><head><title>pyqmd_tpu_torch live</title><style>
body {{ background: #111; color: #ddd; font: 14px monospace; margin: 1em; }}
img {{ border: 1px solid #444; image-rendering: pixelated; }}
button {{ background: #222; color: #ddd; border: 1px solid #555;
         margin: 2px; padding: 4px 8px; font: inherit; cursor: pointer; }}
#status {{ white-space: pre; margin-top: 0.5em; color: #9c9; }}
</style></head><body>
<h3>pyqmd_tpu_torch &mdash; live view</h3>
<img src="/stream" width="{w}" height="{h}">
<div>
<button onclick="c('do=decay')">force decay (SPACE)</button>
<button onclick="c('do=faster')">time &times;10 (&uarr;)</button>
<button onclick="c('do=slower')">time &divide;10 (&darr;)</button>
<button onclick="c('do=bigger')">time &times;2 (&rarr;)</button>
<button onclick="c('do=smaller')">time &divide;2 (&larr;)</button>
<button onclick="c('do=zoomin')">zoom + (Q)</button>
<button onclick="c('do=zoomout')">zoom &minus; (E)</button>
<button onclick="c('preset=real')">real-time (0)</button>
<button onclick="c('preset=year')">yr/s (H)</button>
<button onclick="c('preset=billion')">Gyr/s (B)</button>
</div><div>
isotope: <button onclick="c('iso=H-3')">H-3</button>
<button onclick="c('iso=C-14')">C-14</button>
<button onclick="c('iso=Fe-59')">Fe-59</button>
<button onclick="c('iso=Au-198')">Au-198</button>
<button onclick="c('iso=U-238')">U-238</button>
</div>
<div id="status"></div>
<script>
function c(q) {{ fetch('/control?' + q); }}
async function poll() {{
  try {{
    const r = await fetch('/status'); const s = await r.json();
    document.getElementById('status').textContent =
      JSON.stringify(s, null, 1);
  }} catch (e) {{}}
  setTimeout(poll, 1000);
}}
poll();
document.addEventListener('keydown', (e) => {{
  const m = {{' ': 'do=decay', 'ArrowUp': 'do=faster',
             'ArrowDown': 'do=slower', 'ArrowRight': 'do=bigger',
             'ArrowLeft': 'do=smaller', 'q': 'do=zoomin',
             'e': 'do=zoomout'}};
  if (m[e.key]) {{ c(m[e.key]); e.preventDefault(); }}
}});
</script></body></html>
"""

_BOUNDARY = "pyqmd-frame"

# The reference keymap actions /control accepts (nuclear_sim.py:430-521).
_DO_ACTIONS = frozenset(
    {"decay", "faster", "slower", "bigger", "smaller", "zoomin", "zoomout"}
)


def _json_safe(v):
    """numpy -> python, and non-finite floats -> None: strict JSON has no
    Infinity/NaN, and the browser's ``JSON.parse`` rejects them (a stable
    isotope's ``half_life=inf`` would otherwise kill the status readout)."""
    if hasattr(v, "tolist"):
        v = v.tolist()
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


class LiveViewServer:
    """Own the HTTP server + the simulation lock. ``port=0`` picks an
    ephemeral port (``.port`` reports the bound one)."""

    def __init__(self, sim, host: str = "127.0.0.1", port: int = 8400,
                 fps: float = 30.0, width: int | None = None,
                 height: int | None = None):
        self.sim = sim
        self.lock = threading.Lock()
        self.fps = fps
        self.width = width or min(sim.view_width, 800)
        self.height = height or min(sim.view_height, 600)
        # Shared frame pump state: latest encoded frame + its sequence
        # number + the monotonic time its production completed (see
        # pump_frame). _producing covers the encode window where the
        # lock is released.
        self._frame: bytes | None = None
        self._frame_seq = 0
        self._frame_t = 0.0
        self._producing = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # Quiet request logging (the stream would spam one line/frame).
            def log_message(self, *a):  # noqa: D401
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                url = urlparse(self.path)
                try:
                    if url.path == "/":
                        page = _PAGE.format(w=outer.width, h=outer.height)
                        self._send(200, "text/html", page.encode())
                    elif url.path == "/frame":
                        self._send(200, "image/png", outer.frame_png())
                    elif url.path == "/status":
                        self._send(
                            200, "application/json",
                            json.dumps(outer.status()).encode(),
                        )
                    elif url.path == "/control":
                        q = parse_qs(url.query)
                        try:
                            outer.control(
                                do=q.get("do", [None])[0],
                                preset=q.get("preset", [None])[0],
                                iso=q.get("iso", [None])[0],
                            )
                        except (KeyError, ValueError) as e:
                            # Bad input is the client's error: answer 400
                            # instead of aborting the connection with a
                            # handler traceback.
                            body = json.dumps(
                                {"ok": False, "error": str(e)}
                            ).encode()
                            self._send(400, "application/json", body)
                        else:
                            self._send(
                                200, "application/json", b'{"ok": true}'
                            )
                    elif url.path == "/stream":
                        self._stream()
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # viewer closed the tab mid-write

            def _stream(self):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; boundary={_BOUNDARY}",
                )
                self.end_headers()
                last_seq = -1
                while not outer._closed:
                    seq, png, due = outer.pump_frame(last_seq)
                    if png is not None and seq != last_seq:
                        last_seq = seq  # write only genuinely new frames
                        self.wfile.write(
                            (f"--{_BOUNDARY}\r\nContent-Type: image/png\r\n"
                             f"Content-Length: {len(png)}\r\n\r\n").encode()
                        )
                        self.wfile.write(png)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                    # Sleep keyed to the pump's OWN schedule: a local
                    # full-budget sleep would land production-time short
                    # of the gate and skip every other frame (half fps).
                    time.sleep(max(0.0, due - time.monotonic()) + 0.002)

        self._closed = False
        self._serving = False  # the accept loop was started
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]

    # --- simulation access (all under the lock) -----------------------------

    def _sim_device(self):
        """Context that makes the simulation's CUDA device the calling
        thread's current one (nothing to do for a simulation on the CPU)."""
        if self.sim.device.type == "cuda":
            return torch.cuda.device(self.sim.device)
        return contextlib.nullcontext()

    def frame_png(self) -> bytes:
        """Render the CURRENT state (no stepping) — the /frame endpoint."""
        from pyqmd_tpu_torch.render import png_bytes

        with self.lock, self._sim_device():
            img = self.sim.render(self.width, self.height)
        return png_bytes(img)

    def pump_frame(self, seen: int) -> tuple[int, bytes | None, float]:
        """Advance the simulation at most once per fps budget, whichever
        stream asks first, and hand every caller ``(seq, png, due)`` —
        the latest frame, its sequence number, and the monotonic time to
        ask again: when the next production is due or, while another
        caller is producing, a quarter of a budget from now (``png`` is
        None only while the very first frame is still being produced by
        another stream).

        ``seen`` is the sequence number the caller showed last (-1 before
        its first frame). A caller
        that has not shown the latest frame gets that frame, whatever the
        gate says: a stream that was waiting on the lock while another
        produced frame N must still show N, not go on to produce N + 1
        (two streams would otherwise show alternate frames whenever a
        frame takes longer to make than the budget).

        This is the one place the server steps the simulation: N
        concurrent /stream viewers share one cadence and one frame
        sequence instead of each stepping the shared ``Simulation``
        (which would advance simulated time N times faster and split the
        frames between viewers). The budget gate keys on production
        COMPLETION, so a slow frame (the first one builds the kernels)
        never triggers catch-up stepping and slow production cannot be
        multiplied by viewer count; the steady-state frame period is
        budget + production time. PNG encoding happens OUTSIDE the lock —
        /status and /control stay responsive while a frame compresses."""
        from pyqmd_tpu_torch.render import png_bytes

        budget = 1.0 / max(self.fps, 0.1)
        with self.lock:
            now = time.monotonic()
            due = self._frame_t + budget
            if self._producing:
                # _frame_t may already be the coming frame's: ask again
                # soon, not a budget after a frame not yet published.
                return self._frame_seq, self._frame, now + budget / 4
            if self._frame is not None and (seen != self._frame_seq or now < due):
                return self._frame_seq, self._frame, due
            self._producing = True
        try:
            with self.lock, self._sim_device():
                self.sim.frame()
                img = self.sim.render(self.width, self.height)
                self._frame_t = time.monotonic()  # closes the gate
            png = png_bytes(img)  # outside the lock
            with self.lock:
                self._frame = png
                self._frame_seq += 1
                return self._frame_seq, self._frame, self._frame_t + budget
        finally:
            self._producing = False

    def status(self) -> dict:
        with self.lock, self._sim_device():
            s = dict(self.sim.status())
        return {k: _json_safe(v) for k, v in s.items()}

    def control(self, do=None, preset=None, iso=None) -> None:
        """Apply a control action; raises ``ValueError``/``KeyError`` on
        unknown input (the handler answers 400, not a traceback).
        Validation happens before the lock so a bad request never
        half-applies a combined query."""
        from pyqmd_tpu_torch.data.elements import parse_isotope
        from pyqmd_tpu_torch.sim import TIME_SCALE_PRESETS

        if do is not None and do not in _DO_ACTIONS:
            raise ValueError(
                f"unknown action {do!r}; options: {sorted(_DO_ACTIONS)}"
            )
        if do == "decay" and getattr(self.sim, "batched", False):
            # force_decay raises RuntimeError for ensembles; answer 400
            # instead of letting it abort the connection.
            raise ValueError(
                "force decay requires a single-nucleus simulation"
            )
        if preset is not None and preset not in TIME_SCALE_PRESETS:
            raise KeyError(
                f"unknown preset {preset!r}; options: "
                f"{list(TIME_SCALE_PRESETS)}"
            )
        if iso:
            z, n = parse_isotope(iso)  # raises ValueError on bad input
        with self.lock, self._sim_device():
            if do == "decay":
                self.sim.force_decay()
            elif do == "faster":
                self.sim.scale_time(10.0)
            elif do == "slower":
                self.sim.scale_time(0.1)
            elif do == "bigger":
                self.sim.scale_time(2.0)
            elif do == "smaller":
                self.sim.scale_time(0.5)
            elif do == "zoomin":
                self.sim.zoom_by(1.2)
            elif do == "zoomout":
                self.sim.zoom_by(1.0 / 1.2)
            if preset:
                self.sim.set_preset(preset)  # raises KeyError on bad name
            if iso:
                self.sim.reset(z=z, n=n)

    # --- lifecycle -----------------------------------------------------------

    def serve_forever(self):
        logger.info("live view: http://%s:%d/",
                    self.httpd.server_address[0], self.port)
        self._serving = True
        try:
            self.httpd.serve_forever(poll_interval=0.2)
        finally:
            self.close()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        self._serving = True  # a close() before the thread runs waits for it
        t.start()
        return t

    def close(self):
        self._closed = True
        if self._serving:  # shutdown() waits for a loop: never without one
            self.httpd.shutdown()
        self.httpd.server_close()


def serve(sim, host: str = "127.0.0.1", port: int = 8400,
          fps: float = 30.0) -> None:
    """Blocking convenience entry: serve ``sim`` until Ctrl-C."""
    server = LiveViewServer(sim, host=host, port=port, fps=fps)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
