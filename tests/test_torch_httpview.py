"""The port's browser live view (``render/httpview.py``) on the CPU: the
scenarios of the JAX package's own viewer tests on the port's server, and
the two servers side by side on one seed and one control sequence:
``/status`` equal but for the rate fields (the two float diagnostics to
1e-4), ``/frame`` bitwise equal outside the info panel's device line."""

import json
import struct
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401
from pyqmd_tpu.render.httpview import LiveViewServer as JaxLiveViewServer
from pyqmd_tpu.sim import Simulation as JaxSimulation
from pyqmd_tpu_torch.render import httpview
from pyqmd_tpu_torch.render.httpview import LiveViewServer
from pyqmd_tpu_torch.sim import Simulation

TIMEOUT = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def server():
    sim = Simulation(z=6, n=8, pad_to=16, device="cpu")
    sim.set_time_scale(3.15576e10)
    srv = LiveViewServer(sim, port=0, fps=20, width=160, height=120)
    srv.start_background()
    try:
        yield srv
    finally:
        srv.close()


def _get(srv, path, timeout=TIMEOUT):
    return urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=timeout).read()


def _status(srv):
    return json.loads(_get(srv, "/status"),
                      parse_constant=lambda c: pytest.fail(f"non-JSON constant {c}"))


def _decode_png(data: bytes) -> np.ndarray:
    """The (H, W, 3) image of a PNG as both packages write it (8-bit RGB,
    filter 0 on every scanline)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
    assert (depth, colour) == (8, 2)
    i, idat = 8, b""
    while i < len(data):
        n, tag = struct.unpack(">I4s", data[i:i + 8])
        if tag == b"IDAT":
            idat += data[i + 8:i + 8 + n]
        i += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_page_and_frame(server):
    page = _get(server, "/")
    assert b"/stream" in page and b"/control" in page
    assert b"pyqmd_tpu_torch" in page and b'width="160"' in page
    png = _get(server, "/frame")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(png) > 500  # a real image, not a stub
    img = _decode_png(png)
    assert img.shape == (120, 160, 3) and (img.sum(-1) > 0).sum() > 50


def test_status_json(server):
    st = _status(server)
    # C-14 or its daughter N-14 (the keymap test restores the fixture's
    # isotope, so no other element is reachable in any test order).
    assert st["isotope"].split("-")[0] in ("C", "N")
    assert "time_scale" in st and "decay_counts" in st
    assert st["backend"] == "cpu"


def test_controls_mirror_reference_keymap(server):
    """force decay (SPACE), time-scale steps (arrows), preset, isotope
    select (1-9): nuclear_sim.py:430-521 semantics over HTTP."""
    ts0 = _status(server)["time_scale"]
    _get(server, "/control?do=faster")
    assert _status(server)["time_scale"] == ts0 * 10
    _get(server, "/control?do=slower")
    _get(server, "/control?preset=year")
    assert _status(server)["time_scale"] == 31557600.0
    _get(server, "/control?do=bigger")
    assert _status(server)["time_scale"] == 2 * 31557600.0
    _get(server, "/control?do=smaller")
    zoom0 = server.sim.target_zoom
    _get(server, "/control?do=zoomin")
    assert server.sim.target_zoom == pytest.approx(zoom0 * 1.2)
    _get(server, "/control?do=zoomout")
    _get(server, "/control?iso=U-238")
    st = _status(server)
    assert st["isotope"] == "U-238"
    counts0 = sum(st["decay_counts"])
    _get(server, "/control?do=decay")
    st2 = _status(server)
    assert sum(st2["decay_counts"]) == counts0 + 1  # forced decay landed
    # Restore the module fixture's state for the tests that follow.
    _get(server, "/control?iso=C-14")
    with server.lock:
        server.sim.set_time_scale(3.15576e10)
    assert _status(server)["isotope"] == "C-14"


def test_stream_multipart_parts(server):
    req = urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stream", timeout=TIMEOUT)
    try:
        assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
        buf = b""
        t0 = time.time()
        while buf.count(b"--pyqmd-frame") < 3 and time.time() - t0 < TIMEOUT:
            buf += req.read(4096)
    finally:
        req.close()
    assert buf.count(b"image/png") >= 2
    # Each part carries a well-formed PNG signature after its headers.
    assert buf.index(b"\x89PNG\r\n\x1a\n") > 0


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404


def test_bad_control_returns_400(server):
    """Invalid preset/isotope/action answer 400, not an aborted connection
    with a handler traceback."""
    for q in ("preset=bogus", "iso=Xx-999", "do=teleport"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server, f"/control?{q}")
        assert e.value.code == 400
        body = json.loads(e.value.read())
        assert body["ok"] is False and body["error"]
    # The simulation is still healthy afterwards.
    assert _status(server)["time_scale"] > 0


def test_status_is_strict_json_for_stable_isotope():
    """A stable isotope's half_life=inf must not serialize as the
    non-standard ``Infinity`` token: a browser's JSON.parse rejects it."""
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")  # He-4: stable, half_life=inf
    srv = LiveViewServer(sim, port=0, fps=20, width=80, height=60)
    srv.start_background()
    try:
        raw = _get(srv, "/status")
        assert b"Infinity" not in raw and b"NaN" not in raw
        st = json.loads(raw, parse_constant=lambda c: pytest.fail(f"non-JSON {c}"))
        assert st["half_life"] is None  # inf -> null
    finally:
        srv.close()
    assert httpview._json_safe([np.float32("nan"), (1, float("inf"))]) == [None, [1, None]]


def test_pump_frame_shares_one_stepping_cadence():
    """N concurrent /stream viewers must NOT advance simulated time N
    times faster: pump_frame steps at most once per fps budget and hands
    every caller the same frame + sequence number."""
    sim = Simulation(z=6, n=8, pad_to=16, device="cpu")
    srv = LiveViewServer(sim, port=0, fps=10, width=80, height=60)
    srv.start_background()
    try:
        seq1, png1, due1 = srv.pump_frame(-1)
        seq2, png2, _ = srv.pump_frame(-1)  # immediate second viewer
        assert seq2 == seq1 and png2 is png1
        assert sim.frame_count == 1
        time.sleep(max(0.0, due1 - time.monotonic()) + 0.01)
        seq3, _, _ = srv.pump_frame(seq1)
        assert seq3 == seq1 + 1 and sim.frame_count == 2
    finally:
        srv.close()


def test_pump_cadence_not_halved_by_due_keyed_polls():
    """A viewer sleeping until the pump's returned due time must get a NEW
    frame on every poll."""
    sim = Simulation(z=6, n=8, pad_to=16, device="cpu")
    srv = LiveViewServer(sim, port=0, fps=20, width=80, height=60)
    srv.start_background()
    try:
        seq, _, due = srv.pump_frame(-1)
        for _ in range(5):
            time.sleep(max(0.0, due - time.monotonic()) + 0.002)
            seq2, png, due = srv.pump_frame(seq)
            assert png is not None and seq2 == seq + 1
            seq = seq2
    finally:
        srv.close()


def test_ensemble_force_decay_answers_400():
    """/control?do=decay on an ensemble view must answer 400 (force_decay
    is single-nucleus only), not abort the connection with a traceback."""
    sim = Simulation(z=6, n=8, pad_to=16, ensemble=4, device="cpu")
    srv = LiveViewServer(sim, port=0, fps=10, width=80, height=60)
    srv.start_background()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/control?do=decay")
        assert e.value.code == 400
        # Batched /status still serves (aggregate branch).
        st = _status(srv)
        assert st["ensemble"] == 4 and st["alive"] > 0
        assert _get(srv, "/frame")[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        srv.close()


def test_two_stream_readers_see_one_sequence():
    """Two /stream connections at once: the simulation advances by the
    number of distinct frames, not by twice that."""
    import threading

    sim = Simulation(z=6, n=8, pad_to=16, device="cpu")
    sim.set_time_scale(3.15576e10)  # the panel's clock differs in every frame
    srv = LiveViewServer(sim, port=0, fps=25, width=160, height=120)
    srv.start_background()
    parts = [[], []]

    def read(k):
        req = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stream", timeout=TIMEOUT)
        try:
            buf, t0 = b"", time.time()
            while buf.count(b"--pyqmd-frame") < 7 and time.time() - t0 < TIMEOUT:
                buf += req.read(2048)
        finally:
            req.close()
        parts[k] = buf.split(b"--pyqmd-frame")[1:-1]  # the whole parts: six, by count

    try:
        srv.pump_frame(-1)  # the first frame, before either reader connects
        before = sim.frame_count
        threads = [threading.Thread(target=read, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        pumped = sim.frame_count - before
    finally:
        srv.close()
    both = set(parts[0]) & set(parts[1])
    distinct = len(set(parts[0]) | set(parts[1]))
    assert min(len(parts[0]), len(parts[1])) >= 3 and len(both) >= 2, (len(parts[0]), len(both))
    # while both are connected they show the same frames in the same order,
    # neither skipping one the other shows
    runs = []
    for mine in parts:
        first, last = (min(mine.index(p) for p in both), max(mine.index(p) for p in both))
        runs.append(mine[first:last + 1])
    assert runs[0] == runs[1] and len(runs[0]) == len(both)
    # one cadence: the simulation advanced by the frames made, not by twice
    # that (a frame or two may be pumped while a reader is closing)
    assert distinct - 1 <= pumped <= distinct + 3, (pumped, distinct)
    assert pumped < len(parts[0]) + len(parts[1])


def test_many_pollers_step_the_simulation_once_per_frame():
    """More pollers than cores, a short switch interval: every frame made
    is stepped once and published once, and no poller sees the sequence go
    back."""
    import sys
    import threading

    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    srv = LiveViewServer(sim, port=0, fps=200, width=80, height=60)
    stop = time.monotonic() + 1.5
    bad = []

    def poll():
        last = -1
        while time.monotonic() < stop:
            seq, png, due = srv.pump_frame(last)
            if seq < last or (png is None and seq != 0):
                bad.append((last, seq))
            last = seq
            time.sleep(max(0.0, min(due - time.monotonic(), 0.01)) + 0.001)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=poll) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        srv.close()
    assert not bad, bad[:5]
    assert sim.frame_count == srv._frame_seq >= 3


def test_serve_stops_on_keyboard_interrupt(monkeypatch):
    seen = {}

    def interrupted(self):
        seen["port"] = self.port
        seen["size"] = (self.width, self.height)
        raise KeyboardInterrupt

    monkeypatch.setattr(LiveViewServer, "serve_forever", interrupted)
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    sim.resize(1024, 768)
    httpview.serve(sim, port=0, fps=5)  # returns; the socket is closed
    assert seen["port"] > 0 and seen["size"] == (800, 600)  # capped at 800x600


def test_server_closes_and_its_thread_ends():
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    srv = LiveViewServer(sim, port=0, fps=10, width=80, height=60)
    thread = srv.start_background()
    _get(srv, "/frame")
    srv.close()
    thread.join(10)
    assert not thread.is_alive()
    with pytest.raises(urllib.error.URLError):
        _get(srv, "/status", timeout=5)


# --- the two packages side by side -------------------------------------------------

RATE_FIELDS = ("fps", "substeps_per_sec")
CLOSE_FIELDS = ("rms_radius", "kinetic_energy")
CONTROLS = ["do=faster", "preset=year", "do=bigger", "iso=C-14", "do=decay", "do=zoomin",
            "preset=millennium", "do=smaller"]


def _badge_rows(w, h):
    """Rows of the info panel's first line, which names the device."""
    scale = 2 if min(w, h) >= 400 else 1
    return slice(5 * scale, 5 * scale + 7 * scale)


@pytest.mark.parametrize("size", [(160, 120), (480, 400)])
def test_viewer_equals_the_reference_viewer(size):
    w, h = size
    jsrv = JaxLiveViewServer(JaxSimulation(z=92, n=146, seed=4, pad_to=128), port=0, fps=50,
                             width=w, height=h)
    srv = LiveViewServer(Simulation(z=92, n=146, seed=4, pad_to=128, device="cpu"), port=0,
                         fps=50, width=w, height=h)
    try:
        for s in (jsrv, srv):
            s.start_background()
        for step, q in enumerate(CONTROLS):
            for s in (jsrv, srv):
                assert json.loads(_get(s, f"/control?{q}")) == {"ok": True}
                if step % 3 == 2:
                    # one simulated frame (the port's pump takes the frame last shown)
                    s.pump_frame(s._frame_seq) if s is srv else s.pump_frame()
                    time.sleep(0.03)
            ref, got = _status(jsrv), _status(srv)
            assert list(got) == list(ref), q
            for k in ref:
                if k in RATE_FIELDS or k == "backend":
                    continue
                if k in CLOSE_FIELDS:
                    np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
                else:
                    assert got[k] == ref[k], (q, k)
            a, b = _decode_png(_get(jsrv, "/frame")), _decode_png(_get(srv, "/frame"))
            assert a.shape == b.shape == (h, w, 3)
            keep = np.ones(h, bool)
            keep[_badge_rows(w, h)] = False
            np.testing.assert_array_equal(b[keep], a[keep], err_msg=q)
        assert srv.sim.frame_count == jsrv.sim.frame_count == 2
        assert srv.sim.isotope == jsrv.sim.isotope == "N-14"
        assert _get(srv, "/").replace(b"pyqmd_tpu_torch", b"pyqmd_tpu") == _get(jsrv, "/")
    finally:
        srv.close()
        jsrv.close()
