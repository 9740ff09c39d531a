"""The port's packed frames and pipelined frame reader against the JAX
package's on the same states: the packed (H+2, W) arrays bitwise equal on
the CPU, the unpacked frame bitwise the RGB frame, the reader's queue
discipline, and the rule for how long a frame it hands out stays valid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu import render as jax_render
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.init import init_state as jax_init_state
from pyqmd_tpu.state import ALPHA, ELECTRON, GAMMA, NEUTRON, PROTON
from pyqmd_tpu.state import empty_state as jax_empty_state
from pyqmd_tpu_torch import Simulation, SimConfig, init_state
from pyqmd_tpu_torch.render import (
    PipelinedFrameReader,
    render_frame,
    render_frame_packed,
    unpack_frame,
)
from pyqmd_tpu_torch.render import framebuffer, interactive

W, H = 160, 120


def _both_packed(st, camera, zoom, w, h, ruler=True):
    """(reference packed array, port packed array) of a lone JAX state; the
    port's also unpacks to the port's RGB frame."""
    ref = np.asarray(jax_render.render_frame_packed(st, camera, zoom, w, h, ruler))
    port = tp.to_port_single(st)
    got = render_frame_packed(port, camera, zoom, w, h, ruler)
    assert got.dtype == torch.uint8 and got.shape == (h + 2, w)
    got = got.numpy()
    rgb = unpack_frame(got)
    assert rgb is not None, "exactness flag unset"
    np.testing.assert_array_equal(rgb, render_frame(port, camera, zoom, w, h, ruler).numpy())
    return ref, got


def _fixed_scene():
    """C-14 with six ejecta of every type, distinct fades, one infinite
    life and one dead slot (the scene of the JAX package's own test)."""
    cfg = JaxConfig.for_isotope(6, 8, pad_to=16, max_ejecta=16)
    st = jax_init_state(cfg, seed=3)
    com = np.asarray(st.center_of_mass())
    for i in range(6):
        st = st.replace(
            ej_pos=st.ej_pos.at[i].set(jnp.array([com[0] - 25 + 10.0 * i, com[1] + 18.0])),
            ej_type=st.ej_type.at[i].set([ALPHA, ELECTRON, GAMMA, NEUTRON, PROTON, ALPHA][i]),
            ej_age=st.ej_age.at[i].set(0.37 * i),
            ej_life=st.ej_life.at[i].set(3.0 if i else np.inf),
            ej_alive=st.ej_alive.at[i].set(i != 2),
        )
    return st, (float(com[0]), float(com[1]))


def test_packed_frame_of_the_fixed_scene_is_bitwise_the_reference():
    st, cam = _fixed_scene()
    ref, got = _both_packed(st, cam, 3.0, W, H)
    np.testing.assert_array_equal(got, ref)
    assert got[H + 1, 0] == 1 and got[H + 1, 1] == 10 + 16 - 1
    assert np.array_equal(unpack_frame(got), np.asarray(jax_render.render_frame(st, cam, 3.0, W, H)))
    # the ejecta drew: some pixel indexes an ejecta palette entry
    assert (got[:H] >= interactive.N_BASE).any()
    assert interactive.palette_size(16) == 26


@pytest.mark.parametrize("seed", range(5))
def test_packed_frames_of_random_scenes_are_bitwise_the_reference(seed):
    """Ten scenes per seed: random positions, dead slots, every ejecta type
    at random fades (some infinite lives, some past their life), a random
    ring cursor, camera and zoom."""
    g = np.random.default_rng(100 + seed)
    cfg = JaxConfig.for_isotope(2, 2, pad_to=16)
    base = jax_empty_state(cfg)
    e = cfg.max_ejecta
    w, h = 240, 160
    assert 3 * interactive.palette_size(e) <= w
    for trial in range(10):
        zoom = float(np.float32(g.choice([g.uniform(0.5, 2), g.uniform(2, 12), g.uniform(12, 60)])))
        ext = min(w, h) / zoom / 2
        st = base.replace(
            pos=jnp.asarray(g.uniform(400 - ext, 400 + ext, (16, 2)).astype(np.float32)),
            ptype=jnp.asarray(g.integers(0, 2, 16).astype(np.int32)),
            alive=jnp.asarray(g.uniform(size=16) < 0.8),
            ej_pos=jnp.asarray(g.uniform(400 - ext, 400 + ext, (e, 2)).astype(np.float32)),
            ej_type=jnp.asarray(g.integers(0, 6, e).astype(np.int32)),
            ej_age=jnp.asarray(g.uniform(0, 3.5, e).astype(np.float32)),
            ej_life=jnp.asarray(np.where(g.uniform(size=e) < 0.3, np.inf,
                                         g.uniform(0.5, 3, e)).astype(np.float32)),
            ej_alive=jnp.asarray(g.uniform(size=e) < 0.4),
            ej_cursor=jnp.asarray(int(g.integers(0, 200)), jnp.int32),
        )
        cam = (float(np.float32(g.uniform(399, 401))), float(np.float32(g.uniform(399, 401))))
        ref, got = _both_packed(st, cam, zoom, w, h, ruler=bool(trial % 2))
        np.testing.assert_array_equal(got, ref, err_msg=f"trial {trial} zoom {zoom} cam {cam}")
        assert got[h + 1, 0] == 1


def test_packed_frame_of_an_evolved_nucleus_with_real_ejecta():
    """U-238 after forced decays: the ejecta the physics made, mid-fade."""
    sim = Simulation(z=92, n=146, pad_to=128, seed=0, device="cpu")
    for _ in range(3):
        sim.force_decay()
    sim.frame()
    assert int(sim.state.ej_alive.sum()) > 0
    packed = render_frame_packed(sim.state, (400.0, 400.0), 6.0, 320, 240).numpy()
    assert packed[241, 0] == 1
    np.testing.assert_array_equal(
        unpack_frame(packed), render_frame(sim.state, (400.0, 400.0), 6.0, 320, 240).numpy())


def test_palette_shares_the_rasterizer_colour_helpers():
    """One helper pair for the fade and the final cast, in both files."""
    assert interactive.ejecta_colors is framebuffer.ejecta_colors
    assert interactive.to_rgb8 is framebuffer.to_rgb8
    t = torch.tensor([ALPHA, GAMMA], dtype=torch.int32)
    col = framebuffer.ejecta_colors(t, torch.tensor([1.0, 5.0]), torch.tensor([4.0, 2.0]))
    assert framebuffer.to_rgb8(col).tolist() == [[191, 150, 0], [0, 0, 0]]
    # entry 0 is black, then the six particle colours in type order
    assert interactive._BASE_PALETTE[0].tolist() == [0, 0, 0]
    assert interactive._BASE_PALETTE[1 + GAMMA].tolist() == [0, 255, 0]
    assert interactive.N_BASE == 10 and interactive._BASE_PALETTE.dtype == np.uint8


def test_among_equal_palette_entries_the_first_wins():
    """Fresh ejecta (no fade) repeat a base colour: pixels take the base
    entry's index, as the reference's argmax does."""
    st = jax_empty_state(JaxConfig.for_isotope(2, 2, pad_to=8, max_ejecta=16))
    st = st.replace(
        ej_pos=st.ej_pos.at[0].set(jnp.array([400.0, 400.0])),
        ej_type=st.ej_type.at[0].set(GAMMA),
        ej_life=st.ej_life.at[0].set(np.inf),
        ej_alive=st.ej_alive.at[0].set(True),
    )
    ref, got = _both_packed(st, (400.0, 400.0), 8.0, W, H, ruler=False)
    np.testing.assert_array_equal(got, ref)
    assert got[H // 2, W // 2] == 1 + GAMMA


@pytest.mark.parametrize("kwargs,size", [
    (dict(pad_to=8), (40, 30)),  # 3 * K > width
    (dict(pad_to=8, max_ejecta=247), (800, 600)),  # K > 256
    (dict(pad_to=8, max_ejecta=100), (320, 240)),  # 3 * 110 > 320
])
def test_packed_frame_raises_where_the_palette_cannot_fit(kwargs, size):
    st = init_state(SimConfig.for_isotope(2, 2, **kwargs), seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        render_frame_packed(st, (400.0, 400.0), 4.0, *size)


def test_packed_frame_at_the_largest_palette():
    """246 ejecta slots: K = 256, the length byte holds 255."""
    st = init_state(SimConfig.for_isotope(2, 2, pad_to=8, max_ejecta=246), seed=0, device="cpu")
    assert st.ejecta_capacity == 246
    packed = render_frame_packed(st, (400.0, 400.0), 4.0, 768, 48).numpy()
    assert packed[49, 0] == 1 and packed[49, 1] == 255
    np.testing.assert_array_equal(
        unpack_frame(packed), render_frame(st, (400.0, 400.0), 4.0, 768, 48).numpy())


def test_packed_frame_of_a_batch_member_by_index():
    sim = Simulation(z=6, n=8, pad_to=8, ensemble=3, seed=1, device="cpu")
    frames = [unpack_frame(render_frame_packed(sim.state, (400.0, 401.0), 9.0, 240, 160,
                                               index=i).numpy()) for i in range(3)]
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            f, render_frame(sim.state, (400.0, 401.0), 9.0, 240, 160, index=i).numpy())
    assert (frames[0] != frames[2]).any()


def test_unpack_frame_returns_none_when_the_flag_is_unset():
    st = init_state(SimConfig.for_isotope(2, 2, pad_to=8), seed=0, device="cpu")
    packed = render_frame_packed(st, (400.0, 400.0), 4.0, 240, 40).numpy().copy()
    assert unpack_frame(packed) is not None
    packed[41, 0] = 0
    assert unpack_frame(packed) is None


# --- the reader ------------------------------------------------------------------

def _scenes(n):
    st = init_state(SimConfig.for_isotope(2, 2, pad_to=8, max_ejecta=16), seed=1, device="cpu")
    return st, [(400.0 + 5.0 * i, 400.0) for i in range(n)]


def test_reader_delivers_all_frames_depth_late_and_in_order():
    st, cams = _scenes(6)
    expected = [render_frame(st, c, 4.0, W, H).numpy() for c in cams]
    depth = 3
    reader = PipelinedFrameReader(depth=depth)
    got = []
    for i, c in enumerate(cams):
        out = reader.submit(render_frame_packed(st, c, 4.0, W, H))
        assert (out is None) == (i < depth)
        if out is not None:
            got.append(out)
    assert len(got) == len(cams) - depth  # `depth` frames of latency
    got.extend(reader.flush())
    assert len(got) == len(cams)
    for g, e in zip(got, expected):
        assert np.array_equal(g, e)
    assert reader.flush() == []
    assert not reader._rings  # CPU tensors take no pinned buffer
    with pytest.raises(ValueError):
        PipelinedFrameReader(depth=0)


def test_reader_skips_frames_the_decoder_drops():
    seen = []

    def decode(a):
        seen.append(int(a[0]))
        return None if a[0] % 3 == 1 else a

    reader = PipelinedFrameReader(depth=2, decode=decode)
    out = [reader.submit(torch.full((4,), i, dtype=torch.uint8)) for i in range(6)]
    assert [None if o is None else int(o[0]) for o in out] == [None, None, 0, None, 2, 3]
    assert [int(a[0]) for a in reader.flush()] == [5]  # 4 is dropped
    assert seen == [0, 1, 2, 3, 4, 5]


def test_reader_with_the_identity_decoder_hands_out_rgb_frames():
    """The ``watch`` loop's form: raw RGB frames, decode = identity. On the
    CPU the frame is the tensor's own memory."""
    st, cams = _scenes(4)
    frames = [render_frame(st, c, 4.0, 64, 44) for c in cams]
    reader = PipelinedFrameReader(depth=1, decode=lambda a: a)
    out = [reader.submit(f) for f in frames]
    assert out[0] is None
    for o, f in zip(out[1:], frames):
        assert o.shape == (44, 64, 3) and o.dtype == np.uint8
        assert np.shares_memory(o, f.numpy())
    tail = reader.flush()
    assert len(tail) == 1 and np.array_equal(tail[0], frames[-1].numpy())


class _Event:
    waits = 0

    def record(self, stream):
        pass

    def synchronize(self):
        _Event.waits += 1


class _AsIfOnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on a card, so the reader takes its
    ring path."""

    is_cuda = True


def _pinned_buffers(reader):
    return [b.data_ptr() for ring, _ in reader._rings.values() for b in ring]


@pytest.fixture
def ring_on_the_cpu(monkeypatch):
    """The card's three calls replaced: plain host buffers, an event that
    counts its waits, no stream. Returns the function that dresses a frame."""
    empty = torch.empty

    def unpinned(*shape, pin_memory=False, **kw):
        return empty(*shape, **kw)

    _Event.waits = 0
    monkeypatch.setattr(torch, "empty", unpinned)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return lambda t: t.as_subclass(_AsIfOnTheCard)


def test_ring_of_host_buffers_is_allocated_once_and_a_frame_is_valid_until_the_next_submit(
        ring_on_the_cpu):
    depth = 3
    reader = PipelinedFrameReader(depth=depth, decode=lambda a: a)
    frame = ring_on_the_cpu(torch.zeros(5, 7, dtype=torch.uint8))
    held, first_ring = [], None
    for i in range(12):
        frame.fill_(i)  # the device frame is overwritten: the reader holds a copy
        out = reader.submit(frame)
        first_ring = first_ring or _pinned_buffers(reader)
        if i < depth:
            assert out is None
            continue
        assert (out == i - depth).all()
        assert not np.shares_memory(out, frame.numpy())
        held.append((i - depth, out))
    assert _pinned_buffers(reader) == first_ring and len(set(first_ring)) == depth + 1
    assert _Event.waits == 12 - depth  # one wait per frame handed out, on its own event
    # The rule: a raw frame is valid until the next submit. The newest one
    # handed out is still whole; the one before it has been written over by
    # the copy that the last submit started.
    (_, older), (newest_i, newest) = held[-2], held[-1]
    assert (newest == newest_i).all()
    assert (older == 11).all()
    assert [int(a[0, 0]) for a in reader.flush()] == [9, 10, 11]
    # a second shape gets a ring of its own, the first is not allocated again
    reader.submit(ring_on_the_cpu(torch.zeros(3, dtype=torch.uint8)))
    reader.submit(frame)
    assert _pinned_buffers(reader)[:depth + 1] == first_ring
    assert len(set(_pinned_buffers(reader))) == 2 * (depth + 1)


def test_unpacked_frames_outlive_the_ring(ring_on_the_cpu):
    """The default decoder gathers into a new array: frames handed out stay
    valid however many submits follow."""
    st, cams = _scenes(7)
    expected = [render_frame(st, c, 4.0, W, H).numpy() for c in cams]
    reader = PipelinedFrameReader(depth=2)
    got = [reader.submit(ring_on_the_cpu(render_frame_packed(st, c, 4.0, W, H))) for c in cams]
    assert len(_pinned_buffers(reader)) == 3
    got = [g for g in got if g is not None] + reader.flush()
    assert len(got) == 7
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g, e)


def test_render_package_exports_the_live_view_names():
    from pyqmd_tpu_torch import render

    for name in ("render_frame_packed", "unpack_frame", "PipelinedFrameReader"):
        assert name in render.__all__ and name in jax_render.__all__
        assert getattr(render, name) is getattr(interactive, name)
