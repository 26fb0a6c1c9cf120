"""Runtime configuration for akmc_tpu_torch (a copy of ``akmc_tpu.config``,
kept separate so the port never imports the JAX package).

One typed config object covers both tiers of the reference's configuration:
the runtime ``parameters.txt`` file (reference: src/input_parser.{h,cpp}) and
the compile-time device-layer table (reference: src/structure_input.h).

The ``parameters.txt`` parser is line-for-line behavior compatible with the
reference parser (``//`` comments, substring-matched keys, last-number-wins
value extraction) so existing input decks run unmodified.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import List

# ---------------------------------------------------------------------------
# Physical constants (reference: src/input_parser.h:92-101, kmc_events.cu:5)
# ---------------------------------------------------------------------------
KB_EV = 8.617333262e-5        # [eV/K] Boltzmann constant
Q_C = 1.60217663e-19          # [C] elementary charge
EV_TO_J = 1.60217663e-19      # [J/eV]
H_BAR = 1.054571817e-34       # [Js]
H_BAR_EV = 6.582119569e-16    # [eV s]
H_BAR_SQ = 4.3957e-67         # [(Js)^2]
M_0 = 9.11e-31                # [kg] electron rest mass


@dataclass
class Layer:
    """A device layer with KMC activation energies.

    Mirrors the reference ``Layer`` struct (src/utils.h:63-72) populated from
    src/structure_input.h. Energies in eV, x-ranges in Angstrom.
    """

    type: str
    E_gen_0: float
    E_rec_1: float
    E_diff_2: float   # vacancy diffusion barrier
    E_diff_3: float   # ion (oxygen-interstitial) diffusion barrier
    start_x: float
    end_x: float
    init_vac_percentage: float = 0.0


def default_layers() -> List[Layer]:
    """The TiN/HfO2/Ti/TiN five-layer stack (reference: src/structure_input.h:10-50)."""
    return [
        Layer("contact", 0.0, 0.0, 0.0, 0.76, -22.0, 0.0),
        Layer("interface", 3.93, 0.0, 1.09, 0.76, 0.0, 3.0),
        Layer("oxide", 3.93, 0.0, 1.09, 0.76, 3.0, 48.1431),
        Layer("interface", 1.66, 0.0, 1.09, 0.76, 48.1431, 52.6431),
        Layer("contact", 1.73, 0.0, 0.0, 2.8, 52.6431, 90.0),
    ]


# default seed of the KMC event stream (reference: src/structure_input.h:8)
RND_SEED_KMC_DEFAULT = 1


@dataclass
class KMCParameters:
    """All runtime simulation parameters (reference: src/input_parser.h:12-101)."""

    # random number seed (device construction / substoichiometry stream)
    rnd_seed: int = 0
    # KMC event stream seed (reference hardcodes this in structure_input.h:8)
    rnd_seed_kmc: int = RND_SEED_KMC_DEFAULT

    # restart
    restart: bool = False
    restart_xyz_file: str = ""

    # I/O
    log_freq: int = 10000
    output_freq: int = 1
    log_to_file: bool = True
    verbose: bool = False

    # device atomic structure
    atom_xyz_file: str = ""
    interstitial_xyz_file: str = ""
    pristine: bool = False
    shift: bool = False
    shifts: List[float] = field(default_factory=list)
    initial_vacancy_concentration: float = 0.0
    lattice: List[float] = field(default_factory=list)
    freq: float = 10e13
    nn_dist: float = 3.5
    pbc: bool = False
    num_atoms_first_layer: int = 0
    num_layers_contact: int = 0
    num_atoms_contact: int = 0
    num_atoms_reservoir: int = 0
    metals: List[str] = field(default_factory=list)

    # device constants
    t_ox: float = 0.0
    A: float = 0.0

    # field solvers
    solve_potential: bool = False
    solve_current: bool = False
    solve_heating_global: bool = False
    solve_heating_local: bool = False
    perturb_structure: bool = False

    # biasing scheme
    V_switch: List[float] = field(default_factory=list)
    t_switch: List[float] = field(default_factory=list)
    Icc: float = 0.0
    Rs: float = 0.0

    # potential solver
    G_coeff: float = 1.0
    sigma: float = 3.5e-10
    epsilon: float = 23.0

    # current solver (tunneling)
    m_r: float = 0.85
    V0: float = 1.6
    alpha: List[float] = field(default_factory=list)

    # temperature solver
    k_therm: float = 1.1
    background_temp: float = 300.0
    dissipation_constant: float = 0.0
    small_step: float = 0.0
    event_time: float = 0.0
    delta_t: float = 0.0
    delta: float = 0.0
    power_adjustment_term: float = 0.0
    L_char: float = 0.0
    k_th_metal: float = 0.0
    k_th_non_vacancy: float = 0.0
    k_th_vacancies: float = 0.0
    c_p: float = 0.0

    # device layers (compile-time table in the reference; runtime here)
    layers: List[Layer] = field(default_factory=default_layers)

    # hard-coded constants the reference shadows into its neighbor-list module
    # (reference: Device.cpp:59, neighbor_lists_gpu.cu:262-266)
    max_num_neighbors: int = 52
    cutoff_radius: float = 20.0     # [Angstrom] pairwise interaction cutoff

    # ---- derived (set_expression_parameters, input_parser.cpp:391-398) ----
    @property
    def high_G(self) -> float:
        return self.G_coeff * 1.0

    @property
    def low_G(self) -> float:
        return self.G_coeff * 1e-8

    @property
    def k(self) -> float:
        return 8.987552e9 / self.epsilon

    @property
    def k_th_interface(self) -> float:
        return self.k_th_non_vacancy + (
            self.k_th_vacancies - self.k_th_non_vacancy
        ) * self.initial_vacancy_concentration

    @property
    def tau(self) -> float:
        return self.k_th_interface / (self.L_char * self.L_char * self.c_p * 1e6)

    @property
    def m_e(self) -> float:
        return self.m_r * M_0

    # physical constants as attributes for parity with the reference object
    kB: float = KB_EV
    q: float = Q_C
    h_bar: float = H_BAR
    h_bar_eV: float = H_BAR_EV
    h_bar_sq: float = H_BAR_SQ
    m_0: float = M_0
    eV_to_J: float = EV_TO_J

    # ------------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "KMCParameters":
        """Parse a reference-format ``parameters.txt`` (input_parser.cpp:3-249)."""
        with open(path) as f:
            text = f.read()
        return cls.from_string(text)

    @classmethod
    def from_string(cls, text: str) -> "KMCParameters":
        p = cls()
        for raw in text.splitlines():
            if raw.startswith("//"):
                continue
            line = _trim_after_double_slash(raw)

            def has(key: str) -> bool:
                # reference uses substring match with a trailing space
                # (input_parser.cpp:20 etc.)
                return (key + " ") in line

            if has("rnd_seed"):
                p.rnd_seed = _read_int(line)
            if has("restart"):
                p.restart = _read_bool(line)
            if has("restart_xyz_file"):
                p.restart_xyz_file = _read_string(line)
            if has("log_freq"):
                p.log_freq = _read_int(line)
            if has("output_freq"):
                p.output_freq = _read_int(line)
            if has("log_to_file"):
                p.log_to_file = _read_bool(line)
            if has("verbose"):
                # reference bug kept for parity: 'verbose' writes log_to_file
                # (input_parser.cpp:46-48)
                p.log_to_file = _read_bool(line)
            if has("atom_xyz_file"):
                p.atom_xyz_file = _read_string(line)
            if has("interstitial_xyz_file"):
                p.interstitial_xyz_file = _read_string(line)
            if has("pristine"):
                p.pristine = _read_bool(line)
            if has("shift"):
                p.shift = _read_bool(line)
            if has("pbc"):
                p.pbc = _read_bool(line)
            if has("num_atoms_first_layer"):
                p.num_atoms_first_layer = _read_int(line)
            if has("num_layers_contact"):
                p.num_layers_contact = _read_int(line)
            if has("num_atoms_contact"):
                p.num_atoms_contact = _read_int(line)
            if has("num_atoms_reservoir"):
                p.num_atoms_reservoir = _read_int(line)
            if has("initial_vacancy_concentration"):
                p.initial_vacancy_concentration = _read_double(line)
            if has("nn_dist"):
                p.nn_dist = _read_double(line)
            if has("attempt_frequency"):
                p.freq = _read_double(line)
            if has("shifts"):
                p.shifts = _read_vec_double(line)
            if has("lattice"):
                p.lattice = _read_vec_double(line)
            if has("metals"):
                p.metals = _read_vec_string(line)
            if has("solve_potential"):
                p.solve_potential = _read_bool(line)
            if has("solve_current"):
                p.solve_current = _read_bool(line)
            if has("solve_heating_global"):
                p.solve_heating_global = _read_bool(line)
            if has("solve_heating_local"):
                p.solve_heating_local = _read_bool(line)
            if has("perturb_structure"):
                p.perturb_structure = _read_bool(line)
            if has("V_switch"):
                p.V_switch = _read_vec_double(line)
            if has("t_switch"):
                p.t_switch = _read_vec_double(line)
            if has("Icc"):
                p.Icc = _read_double(line)
            if has("Rs"):
                p.Rs = _read_double(line)
            if has("sigma"):
                p.sigma = _read_double(line)
            if has("epsilon"):
                p.epsilon = _read_double(line)
            if has("m_r"):
                p.m_r = _read_double(line)
            if has("V0"):
                p.V0 = _read_double(line)
            if has("alpha"):
                p.alpha = _read_vec_double(line)
            if has("k_therm"):
                p.k_therm = _read_double(line)
            if has("background_temp"):
                p.background_temp = _read_double(line)
            if has("dissipation_constant"):
                p.dissipation_constant = _read_double(line)
            if has("small_step"):
                p.small_step = _read_double(line)
            if has("event_time"):
                p.event_time = _read_double(line)
            if has("delta_t"):
                p.delta_t = _read_double(line)
            if has("delta"):
                p.delta = _read_double(line)
            if has("power_adjustment_term"):
                p.power_adjustment_term = _read_double(line)
            if has("L_char"):
                p.L_char = _read_double(line)
            if has("k_th_metal"):
                p.k_th_metal = _read_double(line)
            if has("k_th_non_vacancy"):
                p.k_th_non_vacancy = _read_double(line)
            if has("k_th_vacancies"):
                p.k_th_vacancies = _read_double(line)
            if has("c_p"):
                p.c_p = _read_double(line)
            if has("t_ox"):
                p.t_ox = _read_double(line)
            if has("A"):
                dims = _read_vec_double(line)
                a = 1.0
                for d in dims:
                    a *= d
                p.A = a
        return p

    def replace(self, **kwargs) -> "KMCParameters":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# reference-compatible tokenizers (input_parser.cpp:261-388)
# ---------------------------------------------------------------------------

def _trim_after_double_slash(line: str) -> str:
    pos = line.find("//")
    return line[:pos] if pos >= 0 else line


def _read_bool(line: str) -> bool:
    # reference: first of '1'/'0' appearing anywhere (input_parser.cpp:261-273)
    for ch in line:
        if ch == "1":
            return True
        if ch == "0":
            return False
    raise ValueError(f"Invalid input to read_bool: {line}")


def _read_int(line: str) -> int:
    toks = line.split()
    for i, t in enumerate(toks):
        if t == "=" and i + 1 < len(toks):
            return int(float(toks[i + 1]))
    raise ValueError(f"Equal sign and integer not found in input: {line}")


_FLOAT_PREFIX_RE = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?")


def _parse_double_prefix(tok: str):
    """Parse a leading double like C++ ``istringstream >> value`` does
    (stops at the first unparseable char, e.g. '1.92;' -> 1.92)."""
    m = _FLOAT_PREFIX_RE.match(tok)
    return float(m.group(0)) if m else None


def _read_double(line: str) -> float:
    # reference keeps the LAST parseable double on the line
    # (input_parser.cpp:311-336)
    value = 0.0
    for tok in line.split():
        v = _parse_double_prefix(tok)
        if v is not None:
            value = v
    if value == 0.0:
        raise ValueError(f"No double value found in input: {line}")
    return value


def _read_string(line: str) -> str:
    toks = line.split()
    return toks[-1] if toks else ""


def _read_vec_double(line: str) -> List[float]:
    vals = []
    for tok in line.split():
        v = _parse_double_prefix(tok)
        if v is not None:
            vals.append(v)
    return vals


def _read_vec_string(line: str) -> List[str]:
    toks = line.split()
    out = []
    seen_eq = False
    for t in toks:
        if seen_eq:
            out.append(t)
        if t == "=":
            seen_eq = True
    return out
