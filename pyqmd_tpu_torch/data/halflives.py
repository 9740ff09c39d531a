"""Tabulated isotope half-lives.

Physical-constant table covering the reference database
(reference decay_chains.py:13-123: ~70 isotopes from H-1 to Pu-244,
the full U-238 chain membership, common medical/industrial isotopes) PLUS
a beyond-reference completion of the U-235 and Th-232 natural series (22
isotopes down to stable Pb-207/Pb-208) and the full neptunium (4n+1)
series the reference lacks entirely (13 more, Np-237 to stable Tl-205 —
see the section comments below and docs/PARITY.md "Beyond-reference
capabilities"). Values are seconds;
``float('inf')`` marks stable isotopes.

Unlike the reference (a Python dict consulted from host code on every
decay, decay_chains.py:257-262), this table is only the *source of truth*:
``pyqmd_tpu_torch.data.tables`` densifies it into a (Z, N)-indexed device array
so half-life lookups happen on the device inside the step.
"""

from __future__ import annotations

INF = float("inf")

# Time-unit constants (decay_chains.py:6-9).
YEAR = 31557600.0
DAY = 86400.0
HOUR = 3600.0
MINUTE = 60.0

# {(Z, N): half-life in seconds}
HALF_LIVES: dict[tuple[int, int], float] = {
    # Hydrogen
    (1, 0): INF,                 # H-1
    (1, 1): INF,                 # H-2 (deuterium)
    (1, 2): 12.32 * YEAR,        # H-3 (tritium)
    (1, 3): 0.000000000139,      # H-4
    # Helium
    (2, 1): INF,                 # He-3
    (2, 2): INF,                 # He-4
    (2, 3): 0.806,               # He-5
    (2, 4): 0.000000000119,      # He-6
    (2, 6): 0.807,               # He-8
    # Lithium
    (3, 3): INF,                 # Li-6
    (3, 4): INF,                 # Li-7
    (3, 5): 0.839,               # Li-8
    (3, 6): 0.1783,              # Li-9
    # Beryllium
    (4, 3): 53.22 * DAY,         # Be-7
    (4, 5): INF,                 # Be-9
    (4, 6): 1.51e6 * YEAR,       # Be-10
    (4, 7): 13.81,               # Be-11
    # Carbon
    (6, 6): INF,                 # C-12
    (6, 7): INF,                 # C-13
    (6, 8): 5730 * YEAR,         # C-14
    # Nitrogen
    (7, 7): INF,                 # N-14
    (7, 8): INF,                 # N-15
    # Oxygen
    (8, 8): INF,                 # O-16
    (8, 9): INF,                 # O-17
    (8, 10): INF,                # O-18
    # Iron
    (26, 28): INF,               # Fe-54
    (26, 30): INF,               # Fe-56
    (26, 31): INF,               # Fe-57
    (26, 32): INF,               # Fe-58
    (26, 33): 44.5 * DAY,        # Fe-59
    # Medium-weight stables
    (27, 32): INF,               # Co-59
    (28, 30): INF,               # Ni-58
    (29, 34): INF,               # Cu-63
    (30, 34): INF,               # Zn-64
    (36, 48): INF,               # Kr-84
    (38, 50): INF,               # Sr-88
    (42, 56): INF,               # Mo-98
    # Silver
    (47, 60): INF,               # Ag-107
    (47, 62): INF,               # Ag-109
    (47, 58): 8.3 * 60,          # Ag-105
    (47, 56): 5.1 * 60,          # Ag-103
    (47, 63): 2.38 * 60,         # Ag-110m
    (47, 64): 7.45 * DAY,        # Ag-111
    (47, 59): 2.37 * MINUTE,     # Ag-106m
    # Heavy stables
    (78, 117): INF,              # Pt-195
    (79, 118): INF,              # Au-197
    (80, 120): INF,              # Hg-200
    (81, 122): INF,              # Tl-203
    (82, 124): INF,              # Pb-206
    (82, 125): INF,              # Pb-207
    (82, 126): INF,              # Pb-208
    # Uranium
    (92, 142): 2.455e5 * YEAR,   # U-234
    (92, 143): 7.04e8 * YEAR,    # U-235
    (92, 146): 4.468e9 * YEAR,   # U-238
    # Thorium
    (90, 140): 7.54e4 * YEAR,    # Th-230
    (90, 142): 1.405e10 * YEAR,  # Th-232
    (90, 144): 24.10 * DAY,      # Th-234
    # Neptunium / Plutonium
    (93, 144): 2.14e6 * YEAR,    # Np-237
    (94, 145): 6.56e3 * YEAR,    # Pu-239
    (94, 146): 6.56e3 * YEAR,    # Pu-240
    (94, 150): 8.00e7 * YEAR,    # Pu-244
    # Neptunium (4n+1) series — beyond-reference: the FOURTH natural decay
    # series, extinct in nature (Np-237 T << Earth's age) and absent from
    # the reference entirely; runs Np-237 -> ... -> Bi-209 -> Tl-205.
    (91, 142): 26.975 * DAY,     # Pa-233
    (92, 141): 1.592e5 * YEAR,   # U-233
    (90, 139): 7917 * YEAR,      # Th-229
    (88, 137): 14.9 * DAY,       # Ra-225
    (89, 136): 9.92 * DAY,       # Ac-225
    (87, 134): 4.79 * MINUTE,    # Fr-221
    (85, 132): 0.0326,           # At-217
    (83, 130): 45.61 * MINUTE,   # Bi-213 (branch point)
    (84, 129): 3.72e-6,          # Po-213
    (81, 128): 2.16 * MINUTE,    # Tl-209
    (82, 127): 3.234 * HOUR,     # Pb-209 (isotope key 8 in the keymap)
    (83, 126): 2.01e19 * YEAR,   # Bi-209 — the famous near-stable alpha emitter
    (81, 124): INF,              # Tl-205 (stable)
    # Radium / Radon / Polonium
    (88, 138): 1600 * YEAR,      # Ra-226
    (86, 136): 3.8235 * DAY,     # Rn-222
    (84, 124): 138.376 * DAY,    # Po-208
    (84, 126): 138.376 * DAY,    # Po-210
    # Short-lived chain members
    (84, 130): 164.3e-6,         # Po-214
    (84, 134): 3.1 * MINUTE,     # Po-218
    (83, 127): 5.015 * DAY,      # Bi-210
    (83, 131): 19.9 * MINUTE,    # Bi-214
    (82, 128): 22.3 * YEAR,      # Pb-210
    (82, 132): 26.8 * MINUTE,    # Pb-214
    # Medical / industrial
    (27, 33): 5.27 * YEAR,       # Co-60
    (43, 56): 6.01 * HOUR,       # Tc-99m
    (53, 74): 8.02 * DAY,        # I-131
    (55, 82): 30.17 * YEAR,      # Cs-137
    (38, 52): 28.79 * YEAR,      # Sr-90
    # --- Beyond-reference: U-235 (actinium) series completion. The
    # reference tabulates only the first three steps and falls back to its
    # random estimator afterwards (decay_chains.py:146-149); these are the
    # standard values so the whole series is physical (docs/PARITY.md,
    # "Beyond-reference capabilities").
    (90, 141): 25.52 * HOUR,     # Th-231
    (91, 140): 32760 * YEAR,     # Pa-231
    (89, 138): 21.772 * YEAR,    # Ac-227
    (90, 137): 18.68 * DAY,      # Th-227
    (87, 136): 22.00 * MINUTE,   # Fr-223
    (88, 135): 11.43 * DAY,      # Ra-223
    (86, 133): 3.96,             # Rn-219
    (84, 131): 1.781e-3,         # Po-215
    (82, 129): 36.1 * MINUTE,    # Pb-211
    (83, 128): 2.14 * MINUTE,    # Bi-211
    (81, 126): 4.77 * MINUTE,    # Tl-207
    (84, 127): 0.516,            # Po-211
    # --- Beyond-reference: Th-232 (thorium) series completion (the
    # reference stops at Ac-228, decay_chains.py:151-153).
    (88, 140): 5.75 * YEAR,      # Ra-228
    (89, 139): 6.15 * HOUR,      # Ac-228
    (90, 138): 1.9116 * YEAR,    # Th-228
    (88, 136): 3.6319 * DAY,     # Ra-224
    (86, 134): 55.6,             # Rn-220
    (84, 132): 0.145,            # Po-216
    (82, 130): 10.64 * HOUR,     # Pb-212
    (83, 129): 60.55 * MINUTE,   # Bi-212
    (84, 128): 2.99e-7,          # Po-212
    (81, 127): 3.053 * MINUTE,   # Tl-208
}
