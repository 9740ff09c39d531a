"""Element names and symbols, Z = 1..118.

Same coverage as the reference tables at nuclear_sim.py:524-546
and rendering.py:480-526, stored once as parallel lists
indexed by atomic number instead of two duplicated dicts.
"""

from __future__ import annotations

_ELEMENTS: list[tuple[str, str]] = [
    ("Hydrogen", "H"), ("Helium", "He"), ("Lithium", "Li"), ("Beryllium", "Be"),
    ("Boron", "B"), ("Carbon", "C"), ("Nitrogen", "N"), ("Oxygen", "O"),
    ("Fluorine", "F"), ("Neon", "Ne"), ("Sodium", "Na"), ("Magnesium", "Mg"),
    ("Aluminum", "Al"), ("Silicon", "Si"), ("Phosphorus", "P"), ("Sulfur", "S"),
    ("Chlorine", "Cl"), ("Argon", "Ar"), ("Potassium", "K"), ("Calcium", "Ca"),
    ("Scandium", "Sc"), ("Titanium", "Ti"), ("Vanadium", "V"), ("Chromium", "Cr"),
    ("Manganese", "Mn"), ("Iron", "Fe"), ("Cobalt", "Co"), ("Nickel", "Ni"),
    ("Copper", "Cu"), ("Zinc", "Zn"), ("Gallium", "Ga"), ("Germanium", "Ge"),
    ("Arsenic", "As"), ("Selenium", "Se"), ("Bromine", "Br"), ("Krypton", "Kr"),
    ("Rubidium", "Rb"), ("Strontium", "Sr"), ("Yttrium", "Y"), ("Zirconium", "Zr"),
    ("Niobium", "Nb"), ("Molybdenum", "Mo"), ("Technetium", "Tc"), ("Ruthenium", "Ru"),
    ("Rhodium", "Rh"), ("Palladium", "Pd"), ("Silver", "Ag"), ("Cadmium", "Cd"),
    ("Indium", "In"), ("Tin", "Sn"), ("Antimony", "Sb"), ("Tellurium", "Te"),
    ("Iodine", "I"), ("Xenon", "Xe"), ("Cesium", "Cs"), ("Barium", "Ba"),
    ("Lanthanum", "La"), ("Cerium", "Ce"), ("Praseodymium", "Pr"), ("Neodymium", "Nd"),
    ("Promethium", "Pm"), ("Samarium", "Sm"), ("Europium", "Eu"), ("Gadolinium", "Gd"),
    ("Terbium", "Tb"), ("Dysprosium", "Dy"), ("Holmium", "Ho"), ("Erbium", "Er"),
    ("Thulium", "Tm"), ("Ytterbium", "Yb"), ("Lutetium", "Lu"), ("Hafnium", "Hf"),
    ("Tantalum", "Ta"), ("Tungsten", "W"), ("Rhenium", "Re"), ("Osmium", "Os"),
    ("Iridium", "Ir"), ("Platinum", "Pt"), ("Gold", "Au"), ("Mercury", "Hg"),
    ("Thallium", "Tl"), ("Lead", "Pb"), ("Bismuth", "Bi"), ("Polonium", "Po"),
    ("Astatine", "At"), ("Radon", "Rn"), ("Francium", "Fr"), ("Radium", "Ra"),
    ("Actinium", "Ac"), ("Thorium", "Th"), ("Protactinium", "Pa"), ("Uranium", "U"),
    ("Neptunium", "Np"), ("Plutonium", "Pu"), ("Americium", "Am"), ("Curium", "Cm"),
    ("Berkelium", "Bk"), ("Californium", "Cf"), ("Einsteinium", "Es"), ("Fermium", "Fm"),
    ("Mendelevium", "Md"), ("Nobelium", "No"), ("Lawrencium", "Lr"), ("Rutherfordium", "Rf"),
    ("Dubnium", "Db"), ("Seaborgium", "Sg"), ("Bohrium", "Bh"), ("Hassium", "Hs"),
    ("Meitnerium", "Mt"), ("Darmstadtium", "Ds"), ("Roentgenium", "Rg"), ("Copernicium", "Cn"),
    ("Nihonium", "Nh"), ("Flerovium", "Fl"), ("Moscovium", "Mc"), ("Livermorium", "Lv"),
    ("Tennessine", "Ts"), ("Oganesson", "Og"),
]


def element_symbol(z: int) -> str:
    """Symbol for atomic number ``z`` (nuclear_sim.py:524-546 equivalent)."""
    if 1 <= z <= len(_ELEMENTS):
        return _ELEMENTS[z - 1][1]
    return f"E{z}"


def element_name(z: int) -> tuple[str, str]:
    """(full name, symbol) pair (rendering.py:480-526 equivalent)."""
    if 1 <= z <= len(_ELEMENTS):
        return _ELEMENTS[z - 1]
    return f"Element-{z}", f"E{z}"


def isotope_label(z: int, n: int) -> str:
    """Human label like ``U-238``."""
    return f"{element_symbol(z)}-{z + n}"


def parse_isotope(text: str) -> tuple[int, int]:
    """Parse ``'U-238'`` / ``'U238'`` / ``'92:146'`` into (Z, N)."""
    text = text.strip()
    if ":" in text:
        z_s, n_s = text.split(":", 1)
        return int(z_s), int(n_s)
    sym = "".join(c for c in text if c.isalpha())
    mass = "".join(c for c in text if c.isdigit())
    if not sym or not mass:
        raise ValueError(f"cannot parse isotope {text!r}")
    for z, (_, s) in enumerate(_ELEMENTS, start=1):
        if s.lower() == sym.lower():
            a = int(mass)
            if a < z:
                raise ValueError(f"mass number {a} < Z={z} for {sym}")
            return z, a - z
    raise ValueError(f"unknown element symbol {sym!r}")
