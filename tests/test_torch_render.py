"""The port's still renderer against the JAX package's on the same states:
rasterized images bitwise equal on the CPU (the reference's stored golden
hash included), the panel overlays equal but for the acceleration badge,
PNG / APNG / GIF bytes equal for the same arrays."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from pyqmd_tpu import Simulation as JaxSimulation
from pyqmd_tpu import render as jax_render
from pyqmd_tpu.config import SimConfig as JaxConfig
from pyqmd_tpu.core.init import init_state as jax_init_state
from pyqmd_tpu.render.font import render_text as jax_render_text
from pyqmd_tpu.render.panels import compose_panels as jax_compose_panels
from pyqmd_tpu.state import ALPHA, GAMMA, NEUTRON, PARTICLE_COLORS, PROTON
from pyqmd_tpu.state import empty_state as jax_empty_state
from pyqmd_tpu_torch import Simulation, render
from pyqmd_tpu_torch.render.ansi import ansi_render
from pyqmd_tpu_torch.render.font import label_stack, render_text, text_width
from pyqmd_tpu_torch.render.framebuffer import render_frame, render_to_host
from pyqmd_tpu_torch.render.panels import chain_scroll_limit, compose_panels
from pyqmd_tpu_torch.sim import _fit_frame_device

W, H = 160, 120
HE4 = JaxConfig.for_isotope(2, 2, pad_to=8)
GOLDEN = "074164acd52ac0fd4d7abb90484db86da1a287700d250a4a703d2dc04ce12789"


def _both(st, camera, zoom, w, h, ruler=True):
    """(reference image, port image) of a lone JAX state."""
    ref = jax_render.render_to_host(st, camera, zoom, w, h, ruler)
    got = render_to_host(tp.to_port_single(st), camera, zoom, w, h, ruler)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    return ref, got


def _particles(spots, types):
    st = jax_empty_state(HE4)
    for k, ((x, y), t) in enumerate(zip(spots, types)):
        st = st.replace(
            pos=st.pos.at[k].set(jnp.array([x, y])),
            ptype=st.ptype.at[k].set(t),
            alive=st.alive.at[k].set(True),
        )
    return st


def _with_ejecta(st):
    return st.replace(
        ej_pos=st.ej_pos.at[0].set(jnp.array([405.0, 398.0])).at[1].set(jnp.array([404.0, 399.0])),
        ej_type=st.ej_type.at[0].set(ALPHA).at[1].set(GAMMA),
        ej_age=st.ej_age.at[0].set(0.5).at[1].set(0.2),
        ej_life=st.ej_life.at[0].set(2.0).at[1].set(1.0),
        ej_alive=st.ej_alive.at[0].set(True).at[1].set(True),
        ej_cursor=jnp.asarray(2, jnp.int32),
    )


def test_golden_hash_fixed_state():
    """Seed-42 C-14 at zoom 10: the reference's image and its stored hash."""
    st = jax_init_state(JaxConfig.for_isotope(6, 8, pad_to=8), seed=42)
    ref, got = _both(st, (400.0, 400.0), 10.0, W, H)
    np.testing.assert_array_equal(got, ref)
    assert hashlib.sha256(got.tobytes()).hexdigest() == GOLDEN
    assert (got.sum(-1) > 0).sum() > 50


@pytest.mark.parametrize("ptype", [PROTON, NEUTRON])
def test_single_nucleon_colours_highlight_and_ring(ptype):
    st = _particles([(400.0, 400.0)], [ptype])
    ref, got = _both(st, (400.0, 400.0), 4.0, W, H, ruler=False)
    np.testing.assert_array_equal(got, ref)
    cx, cy = W // 2, H // 2
    if ptype == PROTON:
        assert tuple(got[cy, cx + 8]) == tuple(PARTICLE_COLORS[PROTON])
        region = got[cy - 6:cy + 2, cx - 6:cx + 2].reshape(-1, 3)
        assert any(tuple(p) == (255, 150, 150) for p in region)
    else:
        assert tuple(got[cy, cx]) == tuple(PARTICLE_COLORS[NEUTRON])
        assert tuple(got[cy, cx + 9]) == (150, 150, 200)
    assert tuple(got[5, 5]) == (0, 0, 0)


def test_y_sort_order_and_index_ties():
    """The larger world y draws on top; among equal y the larger index."""
    st = _particles([(400.0, 400.0), (400.5, 400.5)], [PROTON, NEUTRON])
    ref, got = _both(st, (400.0, 400.0), 4.0, W, H, ruler=False)
    np.testing.assert_array_equal(got, ref)
    assert tuple(got[H // 2 + 1, W // 2 + 1]) == tuple(PARTICLE_COLORS[NEUTRON])
    tie = _particles([(400.0, 400.0), (401.0, 400.0), (400.5, 400.0)],
                     [PROTON, NEUTRON, PROTON])
    ref, got = _both(tie, (400.0, 400.0), 6.0, W, H, ruler=False)
    np.testing.assert_array_equal(got, ref)


def test_ejecta_fade_and_overdraw():
    st = jax_empty_state(HE4)
    st = st.replace(
        ej_pos=st.ej_pos.at[0].set(jnp.array([400.0, 400.0])),
        ej_type=st.ej_type.at[0].set(GAMMA),
        ej_age=st.ej_age.at[0].set(1.0),
        ej_life=st.ej_life.at[0].set(2.0),
        ej_alive=st.ej_alive.at[0].set(True),
        ej_cursor=jnp.asarray(1, jnp.int32),
    )
    ref, got = _both(st, (400.0, 400.0), 4.0, W, H, ruler=False)
    np.testing.assert_array_equal(got, ref)
    assert got[H // 2, W // 2, 1] in (127, 128) and got[H // 2, W // 2, 0] == 0


@pytest.mark.parametrize("cursor", [0, 2, 5, 70])
def test_most_recent_ejecta_slot_wins(cursor):
    """Overlapping live ejecta in every slot order around the ring cursor."""
    st = jax_empty_state(HE4)
    for k in range(6):
        st = st.replace(
            ej_pos=st.ej_pos.at[k].set(jnp.array([400.0 + 0.4 * k, 400.0])),
            ej_type=st.ej_type.at[k].set(k % 6),
            ej_age=st.ej_age.at[k].set(0.1 * k),
            ej_life=st.ej_life.at[k].set(np.inf if k == 3 else 2.0),
            ej_alive=st.ej_alive.at[k].set(k != 4),
        )
    st = st.replace(ej_cursor=jnp.asarray(cursor, jnp.int32))
    ref, got = _both(st, (400.0, 400.0), 9.0, W, H, ruler=False)
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(-1) > 0).sum() > 100


@pytest.mark.parametrize("zoom", [0.05, 0.1, 1.0, 7.3, 15.0, 22.7, 100.0, 400.0])
def test_ruler_and_label_across_zooms(zoom):
    st = jax_empty_state(HE4)
    ref, got = _both(st, (400.0, 400.0), zoom, 320, 240, ruler=True)
    np.testing.assert_array_equal(got, ref)
    lit = np.flatnonzero((got[240 - 50] == 200).all(-1))
    assert len(lit) > 2 and lit.min() >= 48 and lit.max() < 320


def test_ruler_label_burned_in_and_dropped_where_it_cannot_fit():
    st = jax_empty_state(HE4)
    ref, got = _both(st, (400.0, 400.0), 15.0, 480, 360)
    np.testing.assert_array_equal(got, ref)
    assert (got[360 - 75:360 - 61, 50:150].sum(-1) > 0).sum() > 50
    ref, got = _both(st, (400.0, 400.0), 15.0, 90, 70)  # too small for the label
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("zoom", [0.5, 4.0, 10.0, 15.0, 100.0])
def test_iron_with_ejecta_across_zooms(zoom):
    """The reference's windowed and full-frame paths are equal; the port's
    one path equals both, also where discs outgrow the frame."""
    st = _with_ejecta(jax_init_state(JaxConfig.for_isotope(26, 30, pad_to=8), seed=3))
    ref, got = _both(st, (400.0, 400.0), zoom, 320, 240)
    np.testing.assert_array_equal(got, ref)
    from pyqmd_tpu.render.framebuffer import _render_full

    full = np.asarray(_render_full(st, (400.0, 400.0), zoom, 320, 240))
    np.testing.assert_array_equal(got, full)


def test_frame_edges():
    spots = [(400.0, 400.0), (390.2, 392.6), (410.0, 407.5), (388.0, 400.0),
             (400.0, 409.0), (370.0, 400.0)]
    st = _particles(spots, [PROTON if k % 2 else NEUTRON for k in range(6)])
    ref, got = _both(st, (400.0, 400.0), 8.0, 160, 120, ruler=False)
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(-1) > 0).sum() > 100


def test_non_finite_positions_draw_nothing_of_their_own():
    st = _particles([(400.0, 400.0), (np.nan, 400.0), (401.0, np.nan), (np.inf, 400.0)],
                    [PROTON, NEUTRON, NEUTRON, PROTON])
    ref, got = _both(st, (400.0, 400.0), 5.0, W, H, ruler=False)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(6))
def test_random_scenes_are_bitwise_equal(seed):
    """Sub-pixel positions, y ties, dead slots, every ejecta type, random
    camera and zoom: 100 scenes per seed. One rounding that differs from
    the reference's compiled code (a product fused or not) flips an edge
    pixel in about one scene in a hundred, so the count matters."""
    g = np.random.default_rng(seed)
    cfg = JaxConfig.for_isotope(2, 2, pad_to=16)
    base = jax_empty_state(cfg)
    e = cfg.max_ejecta
    for trial in range(100):
        zoom = float(np.float32(g.choice([g.uniform(0.1, 2), g.uniform(2, 12),
                                          g.uniform(12, 100)])))
        w, h = 240, 160
        ext = min(w, h) / zoom / 2
        pos = g.uniform(400 - ext, 400 + ext, (16, 2)).astype(np.float32)
        if trial % 3 == 0:
            pos[:, 1] = np.round(pos[:, 1])
        st = base.replace(
            pos=jnp.asarray(pos),
            ptype=jnp.asarray(g.integers(0, 2, 16).astype(np.int32)),
            alive=jnp.asarray(g.uniform(size=16) < 0.8),
            ej_pos=jnp.asarray(g.uniform(400 - ext, 400 + ext, (e, 2)).astype(np.float32)),
            ej_type=jnp.asarray(g.integers(0, 6, e).astype(np.int32)),
            ej_age=jnp.asarray(g.uniform(0, 3, e).astype(np.float32)),
            ej_life=jnp.asarray(np.where(g.uniform(size=e) < 0.3, np.inf,
                                         g.uniform(0.5, 3, e)).astype(np.float32)),
            ej_alive=jnp.asarray(g.uniform(size=e) < 0.3),
            ej_cursor=jnp.asarray(int(g.integers(0, 200)), jnp.int32),
        )
        cam = (float(np.float32(g.uniform(399, 401))), float(np.float32(g.uniform(399, 401))))
        ref, got = _both(st, cam, zoom, w, h)
        np.testing.assert_array_equal(got, ref, err_msg=f"trial {trial} zoom {zoom} cam {cam}")


# Pixel offsets (dx, dy) from a particle's screen centre, multiples of
# 2^-12, whose squared distance lies within an ULP of a threshold, so that
# the coverage depends on how dx*dx + dy*dy is rounded. The reference's two
# compiled paths round it differently: both products rounded in the windowed
# path, the x product fused into the sum in the full-frame path.
EDGE_OFFSETS = {
    # disc edge, r = 10 at zoom 4
    "cover": [(9.903076171875, 1.388916015625), (8.742919921875, 4.85400390625),
              (5.998046875, 8.00146484375), (3.945556640625, 9.188720703125),
              (4.85400390625, 8.742919921875), (0.363037109375, 9.993408203125),
              (9.993408203125, 0.363037109375), (8.061767578125, 5.916748046875)],
    # proton highlight, radius 3 around the centre shifted by (-2, -2)
    "highlight": [(1.716796875, 2.460205078125), (2.009765625, 2.227294921875),
                  (2.227294921875, 2.009765625), (2.460205078125, 1.716796875)],
    # neutron ring, |sqrt(d2) - 9| <= 0.5: inner and outer rims
    "ring": [(7.173583984375, 4.5595703125), (4.635498046875, 7.124755859375),
             (8.26318359375, 1.992431640625), (1.773193359375, 8.31298828125),
             (0.973876953125, 9.449951171875), (4.42919921875, 8.404296875),
             (9.021484375, 2.97705078125), (8.330810546875, 4.56591796875)],
    # ejecta disc edge, r = 4 at zoom 4
    "ejecta": [(3.697021484375, 1.527099609375), (1.527099609375, 3.697021484375),
               (1.998291015625, 3.465087890625), (3.465087890625, 1.998291015625)],
}


def _edge_scene(kind, width, height, row):
    """One particle per offset, 55 px apart, each with the pixel
    (30 + 55 k, row) at that offset from its centre. At zoom 4 with the
    camera on (400, 400) the screen transform is exact, so only the
    distance's rounding decides."""
    st = jax_empty_state(HE4)
    pixels = []
    for k, (dx, dy) in enumerate(EDGE_OFFSETS[kind]):
        lx = 30 + 55 * k
        if kind == "highlight":  # the offset is from the highlight's centre
            dx, dy = dx - 2, dy - 2
        px = 400 + (lx - dx - width / 2) / 4
        py = 400 + (row - dy - height / 2) / 4
        assert np.float32(px) == px and np.float32(py) == py
        xy = jnp.array([px, py], jnp.float32)
        if kind == "ejecta":
            st = st.replace(ej_pos=st.ej_pos.at[k].set(xy), ej_type=st.ej_type.at[k].set(GAMMA),
                            ej_alive=st.ej_alive.at[k].set(True))
        else:
            st = st.replace(pos=st.pos.at[k].set(xy), alive=st.alive.at[k].set(True),
                            ptype=st.ptype.at[k].set(NEUTRON if kind == "ring" else PROTON))
        pixels.append((row, lx))
    return st, pixels


@pytest.mark.parametrize("kind", sorted(EDGE_OFFSETS))
def test_edge_pixels_within_an_ulp_follow_the_reference_path_by_path(kind):
    """In a 480x120 frame the reference takes its windowed path, in a
    480x24 frame (no window fits) its full-frame path; the port equals
    each, and the chosen pixels do tell the two roundings apart."""
    seen = []
    for height, row in ((120, 60), (24, 12)):
        st, pixels = _edge_scene(kind, 480, height, row)
        ref, got = _both(st, (400.0, 400.0), 4.0, 480, height, ruler=False)
        np.testing.assert_array_equal(got, ref)
        seen.append([tuple(int(c) for c in ref[y, x]) for y, x in pixels])
    assert seen[0] != seen[1], "the offsets no longer discriminate the two roundings"
    # a zoom known only on the device has the full-frame path's rounding
    st, _ = _edge_scene(kind, 480, 120, 60)
    from pyqmd_tpu.render.framebuffer import _render_full

    full = np.asarray(_render_full(st, (400.0, 400.0), 4.0, 480, 120, False))
    got = render_to_host(tp.to_port_single(st), (400.0, 400.0), torch.tensor(4.0), 480, 120, False)
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("zoom", [0.14375001192092896, 0.1549999862909317, 0.2875000238418579,
                                  0.3099999725818634, 0.7999998927116394, 0.8124998807907104])
def test_ruler_end_and_ticks_within_an_ulp_of_a_pixel(zoom):
    """Zooms that put the bar's end or its last tick within an ULP of a
    pixel boundary: the end is x0 + ruler_len with ruler_len rounded."""
    st = jax_empty_state(HE4)
    ref, got = _both(st, (400.0, 400.0), zoom, 320, 240)
    np.testing.assert_array_equal(got, ref)
    from pyqmd_tpu.render.framebuffer import _render_full

    full = np.asarray(_render_full(st, (400.0, 400.0), zoom, 320, 240))
    got = render_to_host(tp.to_port_single(st), (400.0, 400.0), torch.tensor(zoom), 320, 240)
    np.testing.assert_array_equal(got, full)


def test_zoom_and_camera_may_be_tensors_and_any_member_can_be_drawn():
    sim = Simulation(z=6, n=8, pad_to=8, ensemble=3, seed=1, device="cpu")
    a = render_to_host(sim.state, (400.0, 401.0), 9.0, W, H, index=2)
    b = render_frame(sim.state, torch.tensor([400.0, 401.0]), torch.tensor(9.0), W, H,
                     index=2).numpy()
    np.testing.assert_array_equal(a, b)
    assert (a != render_to_host(sim.state, (400.0, 401.0), 9.0, W, H, index=0)).any()
    low = render_to_host(sim.state, (400.0, 400.0), 0.01, W, H)  # clamped at 0.1
    np.testing.assert_array_equal(low, render_to_host(sim.state, (400.0, 400.0), 0.1, W, H))


def _pair(z, n, pad_to, seed=0, decays=0):
    """A reference Simulation and a port Simulation on the same state."""
    jsim = JaxSimulation(z=z, n=n, seed=seed, pad_to=pad_to)
    for _ in range(decays):
        jsim.force_decay()
    sim = Simulation(z=z, n=n, seed=seed, pad_to=pad_to, device="cpu")
    sim.state = tp.to_port_single(jsim.state)
    sim._chain_cache = None
    return jsim, sim


# Rows of the info panel's first line (the acceleration badge) at scale 2
# and scale 1: the one place the two packages' panels differ by design.
def _badge_rows(w, h):
    scale = 2 if min(w, h) >= 400 else 1
    return slice(5 * scale, 5 * scale + 7 * scale)


@pytest.mark.parametrize("size", [(640, 480), (800, 600), (320, 240)])
def test_render_with_panels_equals_the_reference_but_for_the_badge(size):
    w, h = size
    jsim, sim = _pair(92, 146, 128, decays=3)
    assert sim.isotope == jsim.isotope == "U-234"
    ref, got = jsim.render(w, h), sim.render(w, h)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(sim.render(w, h, panels=False), jsim.render(w, h, panels=False))
    rows = _badge_rows(w, h)
    keep = np.ones(h, bool)
    keep[rows] = False
    np.testing.assert_array_equal(got[keep], ref[keep])
    # the badge itself: the device, not a TPU
    rgb, mask = compose_panels(w, h, sim.status(), sim.chain_entries(),
                               max_substeps=sim.max_substeps, chain_scroll=sim.chain_scroll)
    scale = 2 if min(w, h) >= 400 else 1
    m = render_text("Acceleration: CPU", scale) > 0
    x, y = 5 * scale, 5 * scale
    np.testing.assert_array_equal(mask[y:y + m.shape[0], x:x + m.shape[1]], m)
    np.testing.assert_array_equal(got[mask], rgb[mask])
    np.testing.assert_array_equal(sim.render(w, h), got)  # deterministic


def test_compose_panels_equal_for_the_same_status():
    chain = [dict(index=i, parent=(92, 146 - i), child=(92, 145 - i), symbol="α",
                  duration=1.5 * i) for i in range(30)]
    statuses = [
        dict(isotope="U-238", time_scale=1.0, substeps=4, decay_counts=[0] * 8),
        dict(isotope="C-14 x8", ensemble=8, alive=112, time_scale=3.2e9, substeps=20,
             decay_counts=[0, 1, 2, 0, 0, 0, 0, 0], fps=31.5),
    ]
    jsim, sim = _pair(6, 8, 8, decays=1)
    statuses.append(jsim.status())
    for status in statuses:
        for scroll in (0, 5, 10**6, -3):
            for size in ((400, 300), (800, 600)):
                ref = jax_compose_panels(*size, status, chain, chain_scroll=scroll,
                                         info_scroll=scroll % 4)
                got = compose_panels(*size, status, chain, chain_scroll=scroll,
                                     info_scroll=scroll % 4)
                keep = np.ones(size[1], bool)
                if scroll % 4 == 0:
                    keep[_badge_rows(*size)] = False
                for r, g in zip(ref, got):
                    np.testing.assert_array_equal(g[keep], r[keep])
    assert chain_scroll_limit(800, 600, 30) > 0


def test_chain_scroll_clamps_on_render_and_resize_sets_the_viewport():
    jsim, sim = _pair(92, 146, 128, decays=3)
    sim.chain_scroll = jsim.chain_scroll = 10**6
    sim.render(400, 300)
    jsim.render(400, 300)
    assert sim.chain_scroll == jsim.chain_scroll <= 3
    sim.resize(320, 240)
    img = sim.render()
    assert img.shape == (240, 320, 3)
    sim.info_scroll = 3
    assert (img != sim.render()).any()
    sim.resize(1, 1)
    assert (sim.view_width, sim.view_height) == (16, 16)


def test_font_and_labels_equal_the_reference():
    for s in ("U-238", "Half-life: 4.47e+03 million years", "U-238 → Th-234 (α)", "β-", "γ",
              "164.30 μs", "↑ More ↑", "\x7f"):
        for scale in (1, 2, 3):
            np.testing.assert_array_equal(render_text(s, scale), jax_render_text(s, scale))
    assert text_width("ab", 2) == 24
    assert label_stack(["1 fm", "10 fm"], scale=2).shape[0] == 2


def test_fit_views_ascii_and_ansi_equal_the_reference():
    jsim, sim = _pair(6, 8, 16)
    np.testing.assert_array_equal(sim._render_fit(64, 44), jsim._render_fit(64, 44))
    assert sim.render_ascii() == jsim.render_ascii()
    assert sim.render_ansi() == jsim.render_ansi()
    assert "\x1b[38;2;" in sim.render_ansi()
    assert ansi_render(np.zeros((4, 4, 3), np.uint8)).count("\n") == 1


@pytest.mark.parametrize("zn,pad_to", [((6, 8), 16), ((92, 146), 128), ((2, 2), 8)])
def test_fit_frame_device_equals_render_fit(zn, pad_to):
    """Camera fit on the device (f32) against the host fit (f64): the same
    view, as the reference holds its own pair to."""
    jsim, sim = _pair(*zn, pad_to)
    dev = sim.render_fit_device(64, 44)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    host = sim._render_fit(64, 44)
    assert dev.shape == host.shape == (44, 64, 3)
    assert (dev.numpy() == host).mean() > 0.995
    ref = np.asarray(jsim.render_fit_device(64, 44))
    assert (dev.numpy() == ref).mean() > 0.995
    direct = _fit_frame_device(sim.state, 64, 44, [400.0, 400.0])
    np.testing.assert_array_equal(direct.numpy(), dev.numpy())


def test_fit_frame_device_with_nothing_alive_uses_the_origin():
    sim = Simulation(z=2, n=2, pad_to=8, device="cpu")
    sim.state = sim.state.replace(alive=torch.zeros_like(sim.state.alive))
    np.testing.assert_array_equal(sim.render_fit_device(40, 30).numpy(), sim._render_fit(40, 30))


def test_ensemble_montage_equals_the_reference():
    jsim = JaxSimulation(z=2, n=2, pad_to=8, ensemble=6)
    sim = Simulation(z=2, n=2, pad_to=8, ensemble=6, device="cpu")
    sim.state = tp.to_port(jsim.state)
    grid = sim.render_grid(nx=3, ny=2, tile=40)
    assert grid.shape == (80, 120, 3)
    np.testing.assert_array_equal(grid, jsim.render_grid(nx=3, ny=2, tile=40))
    wide = sim.render_grid(nx=4, ny=2, tile=24)  # 8 tiles, 6 members: the last two empty
    assert wide.shape == (48, 96, 3)
    assert (wide[25:, 49:72] == 0).all() and (wide[25:, 73:] == 0).all()  # inside the borders
    with pytest.raises(RuntimeError):
        Simulation(z=2, n=2, pad_to=8, device="cpu").render_grid()


def test_png_apng_gif_bytes_equal_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    img = (np.arange(W * H * 3, dtype=np.uint32) % 256).astype(np.uint8).reshape(H, W, 3)
    assert render.png_bytes(img) == jax_render.png_bytes(img)
    assert render.png_bytes(img)[:8] == b"\x89PNG\r\n\x1a\n"
    frames = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(3)]
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    render.write_apng(str(a), frames, fps=10)
    jax_render.write_apng(str(b), frames, fps=10)
    assert a.read_bytes() == b.read_bytes() and b"acTL" in a.read_bytes()
    render.write_png(str(a), img)
    assert a.read_bytes() == render.png_bytes(img)
    movie = []
    base = np.zeros((24, 32, 3), np.uint8)
    for i in range(4):
        f = base.copy()
        f[4 + i:12 + i, 3 + 2 * i:11 + 2 * i] = (200, 40, 40)
        movie.append(f)
    noisy = [rng.integers(0, 256, (16, 20, 3), dtype=np.uint8) for _ in range(2)]
    for seq in (movie, noisy, [movie[0], movie[0].copy()]):
        for mode in ("auto", "fast", "compact"):
            assert render.gif_bytes(seq, fps=10, mode=mode) == jax_render.gif_bytes(
                seq, fps=10, mode=mode)
    render.write_gif(str(tmp_path / "m.gif"), movie, fps=10)
    data = (tmp_path / "m.gif").read_bytes()
    assert data[:6] == b"GIF89a" and data == jax_render.gif_bytes(movie, fps=10)
