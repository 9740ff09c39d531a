"""Decay-chain database and pure decay-mode predictor.

Chain coverage mirrors the reference (reference decay_chains.py:126-167):
the full 14-step U-238 series with the Po-218 and Bi-214 branch points
(0.9998/0.0002 splits), the U-235 and Th-232 series openings, medical and
fission-product isotopes, and the light H-3 / C-14 chains — plus a
beyond-reference completion of the U-235 (actinium) and Th-232 (thorium)
natural series down to stable Pb-207 / Pb-208 AND the extinct neptunium
(4n+1) series (Np-237 to stable Tl-205), so all FOUR natural decay series
run end to end on tabulated physics instead of falling back to the
random estimator (docs/PARITY.md "Beyond-reference capabilities").

The reference predicts modes for unlisted isotopes by *mutating the global
dict as a cache* (decay_chains.py:169-201). Here ``predict_decay`` is a pure
function, and the whole (tabulated + predicted) space is densified once into
device tables by :mod:`pyqmd_tpu_torch.data.tables`, so branch sampling happens
on the device with no host round trip.
"""

from __future__ import annotations

from pyqmd_tpu_torch.state import (
    DECAY_ALPHA,
    DECAY_BETA_MINUS,
    DECAY_BETA_PLUS,
    DECAY_GAMMA,
    DECAY_NONE,
    DECAY_PROTON_EMISSION,
)

# {(Z, N): [(new_Z, new_N, decay_type, branch_probability), ...]}
# Branch probabilities are sampled cumulatively, first branch is the default
# (matching decay_chains.py:221-229).
DECAY_CHAINS: dict[tuple[int, int], list[tuple[int, int, int, float]]] = {
    # U-238 series
    (92, 146): [(90, 144, DECAY_ALPHA, 1.0)],            # U-238 -> Th-234
    (90, 144): [(91, 143, DECAY_BETA_MINUS, 1.0)],       # Th-234 -> Pa-234
    (91, 143): [(92, 142, DECAY_BETA_MINUS, 1.0)],       # Pa-234 -> U-234
    (92, 142): [(90, 140, DECAY_ALPHA, 1.0)],            # U-234 -> Th-230
    (90, 140): [(88, 138, DECAY_ALPHA, 1.0)],            # Th-230 -> Ra-226
    (88, 138): [(86, 136, DECAY_ALPHA, 1.0)],            # Ra-226 -> Rn-222
    (86, 136): [(84, 134, DECAY_ALPHA, 1.0)],            # Rn-222 -> Po-218
    (84, 134): [(82, 132, DECAY_ALPHA, 0.9998),          # Po-218 -> Pb-214
                (83, 133, DECAY_BETA_PLUS, 0.0002)],     # Po-218 -> At-218
    (82, 132): [(83, 131, DECAY_BETA_MINUS, 1.0)],       # Pb-214 -> Bi-214
    (83, 131): [(84, 130, DECAY_BETA_MINUS, 0.9998),     # Bi-214 -> Po-214
                (81, 133, DECAY_ALPHA, 0.0002)],         # Bi-214 -> Tl-210
    (84, 130): [(82, 128, DECAY_ALPHA, 1.0)],            # Po-214 -> Pb-210
    (82, 128): [(83, 127, DECAY_BETA_MINUS, 1.0)],       # Pb-210 -> Bi-210
    (83, 127): [(84, 126, DECAY_BETA_MINUS, 1.0)],       # Bi-210 -> Po-210
    (84, 126): [(82, 124, DECAY_ALPHA, 1.0)],            # Po-210 -> Pb-206 (stable)
    # U-235 series — first three steps as tabulated by the reference
    # (decay_chains.py:146-149) ...
    (92, 143): [(90, 141, DECAY_ALPHA, 1.0)],            # U-235 -> Th-231
    (90, 141): [(91, 140, DECAY_BETA_MINUS, 1.0)],       # Th-231 -> Pa-231
    (91, 140): [(89, 138, DECAY_ALPHA, 1.0)],            # Pa-231 -> Ac-227
    # ... and the beyond-reference completion to stable Pb-207 (the
    # reference's estimator+predictor takes over at Ac-227; these are the
    # standard branches, incl. the Ac-227 and Bi-211 branch points).
    (89, 138): [(90, 137, DECAY_BETA_MINUS, 0.9862),     # Ac-227 -> Th-227
                (87, 136, DECAY_ALPHA, 0.0138)],         # Ac-227 -> Fr-223
    (90, 137): [(88, 135, DECAY_ALPHA, 1.0)],            # Th-227 -> Ra-223
    (87, 136): [(88, 135, DECAY_BETA_MINUS, 1.0)],       # Fr-223 -> Ra-223
    (88, 135): [(86, 133, DECAY_ALPHA, 1.0)],            # Ra-223 -> Rn-219
    (86, 133): [(84, 131, DECAY_ALPHA, 1.0)],            # Rn-219 -> Po-215
    (84, 131): [(82, 129, DECAY_ALPHA, 1.0)],            # Po-215 -> Pb-211
    (82, 129): [(83, 128, DECAY_BETA_MINUS, 1.0)],       # Pb-211 -> Bi-211
    (83, 128): [(81, 126, DECAY_ALPHA, 0.99724),         # Bi-211 -> Tl-207
                (84, 127, DECAY_BETA_MINUS, 0.00276)],   # Bi-211 -> Po-211
    (81, 126): [(82, 125, DECAY_BETA_MINUS, 1.0)],       # Tl-207 -> Pb-207 (stable)
    (84, 127): [(82, 125, DECAY_ALPHA, 1.0)],            # Po-211 -> Pb-207 (stable)
    # Th-232 series — first three steps as tabulated by the reference
    # (decay_chains.py:151-153) ...
    (90, 142): [(88, 140, DECAY_ALPHA, 1.0)],            # Th-232 -> Ra-228
    (88, 140): [(89, 139, DECAY_BETA_MINUS, 1.0)],       # Ra-228 -> Ac-228
    (89, 139): [(90, 138, DECAY_BETA_MINUS, 1.0)],       # Ac-228 -> Th-228
    # ... and the beyond-reference completion to stable Pb-208 (incl. the
    # famous Bi-212 64/36 branch point).
    (90, 138): [(88, 136, DECAY_ALPHA, 1.0)],            # Th-228 -> Ra-224
    (88, 136): [(86, 134, DECAY_ALPHA, 1.0)],            # Ra-224 -> Rn-220
    (86, 134): [(84, 132, DECAY_ALPHA, 1.0)],            # Rn-220 -> Po-216
    (84, 132): [(82, 130, DECAY_ALPHA, 1.0)],            # Po-216 -> Pb-212
    (82, 130): [(83, 129, DECAY_BETA_MINUS, 1.0)],       # Pb-212 -> Bi-212
    (83, 129): [(84, 128, DECAY_BETA_MINUS, 0.6406),     # Bi-212 -> Po-212
                (81, 127, DECAY_ALPHA, 0.3594)],         # Bi-212 -> Tl-208
    (84, 128): [(82, 126, DECAY_ALPHA, 1.0)],            # Po-212 -> Pb-208 (stable)
    (81, 127): [(82, 126, DECAY_BETA_MINUS, 1.0)],       # Tl-208 -> Pb-208 (stable)
    # Neptunium (4n+1) series — beyond-reference: the fourth natural decay
    # series (extinct; absent from the reference), Np-237 down to Tl-205
    # via the Bi-213 branch point and the 2e19-year Bi-209 alpha decay.
    (93, 144): [(91, 142, DECAY_ALPHA, 1.0)],            # Np-237 -> Pa-233
    (91, 142): [(92, 141, DECAY_BETA_MINUS, 1.0)],       # Pa-233 -> U-233
    (92, 141): [(90, 139, DECAY_ALPHA, 1.0)],            # U-233 -> Th-229
    (90, 139): [(88, 137, DECAY_ALPHA, 1.0)],            # Th-229 -> Ra-225
    (88, 137): [(89, 136, DECAY_BETA_MINUS, 1.0)],       # Ra-225 -> Ac-225
    (89, 136): [(87, 134, DECAY_ALPHA, 1.0)],            # Ac-225 -> Fr-221
    (87, 134): [(85, 132, DECAY_ALPHA, 1.0)],            # Fr-221 -> At-217
    (85, 132): [(83, 130, DECAY_ALPHA, 1.0)],            # At-217 -> Bi-213
    (83, 130): [(84, 129, DECAY_BETA_MINUS, 0.9791),     # Bi-213 -> Po-213
                (81, 128, DECAY_ALPHA, 0.0209)],         # Bi-213 -> Tl-209
    (84, 129): [(82, 127, DECAY_ALPHA, 1.0)],            # Po-213 -> Pb-209
    (81, 128): [(82, 127, DECAY_BETA_MINUS, 1.0)],       # Tl-209 -> Pb-209
    (82, 127): [(83, 126, DECAY_BETA_MINUS, 1.0)],       # Pb-209 -> Bi-209
    (83, 126): [(81, 124, DECAY_ALPHA, 1.0)],            # Bi-209 -> Tl-205 (stable)
    # Medical isotopes
    (43, 56): [(43, 56, DECAY_GAMMA, 0.99),              # Tc-99m -> Tc-99
               (43, 56, DECAY_BETA_MINUS, 0.01)],        # Tc-99m -> Ru-99
    (53, 74): [(54, 73, DECAY_BETA_MINUS, 1.0)],         # I-131 -> Xe-131
    # Fission products
    (55, 82): [(56, 81, DECAY_BETA_MINUS, 1.0)],         # Cs-137 -> Ba-137m
    (38, 52): [(39, 51, DECAY_BETA_MINUS, 1.0)],         # Sr-90 -> Y-90
    # Light elements
    (1, 2): [(2, 1, DECAY_BETA_MINUS, 1.0)],             # H-3 -> He-3
    (6, 8): [(7, 7, DECAY_BETA_MINUS, 1.0)],             # C-14 -> N-14
}


def stable_nz_ratio(z: int) -> float:
    """Empirical stability-band N/Z ratio (decay_chains.py:182-187)."""
    if z < 20:
        return 1.0
    return 1.0 + 0.015 * z**1.3


def predict_decay(z: int, n: int) -> list[tuple[int, int, int, float]]:
    """Predict the decay mode of an untabulated isotope from its N/Z ratio.

    Pure reimplementation of the reference's ``expand_decay_chain``
    (decay_chains.py:169-201): very heavy elements alpha-decay; neutron-rich
    isotopes beta-minus; proton-rich isotopes beta-plus (Z > 30) or
    proton-emission; isotopes inside the stability band are treated as
    non-decaying. Unlike the reference, no global state is mutated.
    """
    n_to_z = n / max(1, z)
    stable_ratio = stable_nz_ratio(z)

    if z > 83:
        return [(z - 2, n - 2, DECAY_ALPHA, 0.9)]
    if n_to_z > stable_ratio + 0.15:
        return [(z + 1, n - 1, DECAY_BETA_MINUS, 0.9)]
    if n_to_z < stable_ratio - 0.15:
        if z > 30:
            return [(z - 1, n + 1, DECAY_BETA_PLUS, 0.9)]
        return [(z - 1, n, DECAY_PROTON_EMISSION, 0.9)]
    return [(z, n, DECAY_NONE, 1.0)]


def decay_branches(z: int, n: int) -> list[tuple[int, int, int, float]]:
    """Tabulated branches if known, otherwise the predicted mode."""
    key = (z, n)
    if key in DECAY_CHAINS:
        return DECAY_CHAINS[key]
    return predict_decay(z, n)
