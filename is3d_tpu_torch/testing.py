"""Synthetic fixtures: surfaces, species lists, delta-f data, and a complete
run directory, all made from a numpy seed.

The repository ships no PDG or delta-f data, so these are what the tests
and ``chip_smoke.py`` drive.  Magnitudes mimic a realistic (2+1)D / (3+1)D
freeze-out surface near T ~ 0.155 GeV.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .data import SpeciesArrays
from .io.surface import Surface, surface_from_arrays
from .io.deltaf import DeltafData, compute_jonah_arrays
from .physics.splines import build_natural_cubic
from .units import HBARC

# (mass GeV, sign, degeneracy, baryon) for pi+- pi0 K+- p pbar n Lambda rho Delta
_SPECIES_SEED = [
    (0.13957, -1.0, 1.0, 0.0), (0.13957, -1.0, 1.0, 0.0), (0.13498, -1.0, 1.0, 0.0),
    (0.49368, -1.0, 1.0, 0.0), (0.49368, -1.0, 1.0, 0.0),
    (0.93827, 1.0, 2.0, 1.0), (0.93827, 1.0, 2.0, -1.0),
    (0.93957, 1.0, 2.0, 1.0), (1.11568, 1.0, 2.0, 1.0),
    (0.77526, -1.0, 3.0, 0.0), (1.23200, 1.0, 4.0, 1.0),
]
# the same hadrons as PDG entries (mcid, name, strange, charge); pbar is
# the reader's mirror of the proton
_SEED_MCIDS = (211, -211, 111, 321, -321, 2212, -2212, 2112, 3122, 113, 2224)
_SEED_PDG = {211: ("pi+", 0, 1), -211: ("pi-", 0, -1), 111: ("pi0", 0, 0),
             321: ("K+", 1, 1), -321: ("K-", -1, -1), 2212: ("p", 0, 1),
             2112: ("n", 0, 0), 3122: ("Lambda", -1, 0), 113: ("rho0", 0, 0),
             2224: ("Delta++", 0, 2)}


def synthetic_species(n_species: int = 11, dtype=torch.float64,
                      device="cpu", seed: int = 0) -> SpeciesArrays:
    """A plausible hadron list.  The first 11 entries are real hadrons; any
    further entries are resonance-like (mass grows, alternating statistics)."""
    rng = np.random.default_rng(seed)
    rows = list(_SPECIES_SEED)
    while len(rows) < n_species:
        i = len(rows)
        mass = 1.0 + 0.005 * i + 0.1 * rng.random()
        sign = -1.0 if i % 2 else 1.0
        deg = float(rng.integers(1, 6))
        baryon = float(rng.integers(-1, 2)) if sign > 0 else 0.0
        rows.append((mass, sign, deg, baryon))
    cols = np.asarray(rows[:n_species], dtype=np.float64)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    z = t(np.zeros(n_species))
    return SpeciesArrays(mass=t(cols[:, 0]), sign=t(cols[:, 1]),
                         degeneracy=t(cols[:, 2]), baryon=t(cols[:, 3]),
                         equilibrium_density=z, bulk_density=z,
                         diff_density=z)


def synthetic_surface_cells(n_cells: int, dimension: int = 2,
                            seed: int = 0) -> dict:
    """Random but physical freeze-out cells (numpy dict of columns)."""
    rng = np.random.default_rng(seed)
    n = n_cells
    return dict(
        tau=rng.uniform(1.0, 10.0, n),
        x=rng.uniform(-8, 8, n), y=rng.uniform(-8, 8, n),
        eta=(rng.uniform(-3, 3, n) if dimension == 3 else np.zeros(n)),
        dat=rng.uniform(-0.1, 1.0, n), dax=rng.uniform(-0.5, 0.5, n),
        day=rng.uniform(-0.5, 0.5, n),
        dan=(rng.uniform(-0.05, 0.05, n) if dimension == 3 else np.zeros(n)),
        ux=rng.uniform(-0.8, 0.8, n), uy=rng.uniform(-0.8, 0.8, n),
        un=rng.uniform(-0.05, 0.05, n),
        T=rng.uniform(0.148, 0.162, n),
        E=rng.uniform(0.25, 0.40, n), P=rng.uniform(0.04, 0.08, n),
        pixx=rng.normal(0, 0.004, n), pixy=rng.normal(0, 0.002, n),
        pixn=rng.normal(0, 0.001, n), piyy=rng.normal(0, 0.004, n),
        piyn=rng.normal(0, 0.001, n),
        bulkPi=rng.normal(0, 0.003, n),
        muB=np.zeros(n), nB=np.zeros(n),
        Vx=np.zeros(n), Vy=np.zeros(n), Vn=np.zeros(n),
    )


def synthetic_surface(n_cells: int, dimension: int = 2, seed: int = 0,
                      dtype=torch.float64, device="cpu") -> Surface:
    return surface_from_arrays(
        dtype=dtype, device=device,
        **synthetic_surface_cells(n_cells, dimension, seed))


def synthetic_deltaf_data(dtype=torch.float64, device="cpu",
                          T_avg: float = 0.155) -> DeltafData:
    """DeltafData with smooth, dimensionally sensible fake coefficient tables
    (same raw T-power scalings the real files use) plus real Jonah splines
    computed from the seed species list."""
    nT, nmuB = 101, 81
    T = np.linspace(0.07, 0.25, nT)
    muB = np.linspace(0.0, 0.8, nmuB)
    mu_fac = (1.0 + 0.1 * muB)[:, None]                       # (nmuB, 1)

    base = {
        "c0": 2.0 + T, "c1": 0.5 + 0.2 * T, "c2": 1.0 + 0.5 * T,
        "c3": 0.3 + 0.1 * T, "c4": 0.2 + 0.1 * T,
        "F": 0.05 + 0.3 * T, "G": 0.05 + 0.1 * T,
        "betabulk": 0.02 + 0.1 * T, "betaV": 0.4 + 0.2 * T,
        "betapi": 0.6 + 1.0 * T,
    }
    raw = {k: np.broadcast_to(v[None, :] * mu_fac, (nmuB, nT)).copy()
           for k, v in base.items()}
    spl = lambda x, y: build_natural_cubic(x, y, dtype, device)
    splines = {name: spl(T, raw[name][0])
               for name in ("c0", "c2", "c3", "F", "betabulk", "betaV", "betapi")}

    seed_rows = np.asarray(_SPECIES_SEED, dtype=np.float64)
    x, lam2, z = compute_jonah_arrays(seed_rows[:, 0], seed_rows[:, 2],
                                      seed_rows[:, 1], T_avg)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return DeltafData(
        T_grid=t(T), muB_grid=t(muB),
        tables={k: t(v) for k, v in raw.items()},
        splines=splines,
        lambda2_spline=spl(x, lam2), z_spline=spl(x, z),
        bulkPi_over_Peq_max=t(float(x.max())),
    )


# --------------------------------------------------------------- run dir

def _pdg_entries(n_species: int, rng) -> list:
    """PDG rows (mcid, name, mass, gspin, baryon, strange, charge) whose
    table holds at least ``n_species`` species once the reader has mirrored
    the baryons: the seed hadrons, then resonance-like entries alternating
    meson and baryon."""
    rows = []
    for mcid, (mass, _sign, deg, baryon) in zip(_SEED_MCIDS, _SPECIES_SEED):
        if mcid < 0 and baryon != 0:
            continue                       # antibaryon: mirrored by the reader
        name, strange, charge = _SEED_PDG[mcid]
        rows.append((mcid, name, mass, deg, int(baryon), strange, charge))
    count = lambda: sum(2 if r[4] > 0 else 1 for r in rows)
    i = len(_SPECIES_SEED)
    while count() < n_species:
        mass = 1.0 + 0.005 * i + 0.1 * rng.random()
        deg = float(rng.integers(1, 6))
        if i % 2:
            rows.append((9000000 + i, f"meson{i}", mass, deg, 0, 0, 0))
        else:
            rows.append((9100000 + i, f"baryon{i}", mass, deg, 1, 0, 0))
        i += 1
    return rows


def _write_pdg(path: str, rows: list):
    with open(path, "w") as f:
        for mcid, name, mass, deg, baryon, strange, charge in rows:
            f.write(f"{mcid} {name} {mass:.6f} 0.000000 {deg:.0f} {baryon} "
                    f"{strange} 0 0 1 {charge} 1\n")
            # stable: one self-decay line (mcid, 1 daughter, branch 1)
            f.write(f"{mcid} 1 1.000000 {mcid} 0 0 0 0\n")


def _chosen_mcids(rows: list, n_species: int) -> list:
    table = []
    for r in rows:
        table.append(r[0])
        if r[4] > 0:
            table.append(-r[0])
    chosen = [m for m in _SEED_MCIDS][:n_species]
    chosen += [m for m in table if m not in chosen][:n_species - len(chosen)]
    if len(chosen) != n_species:
        raise ValueError(f"PDG list too short for {n_species} species")
    return chosen


_RUN_PARAMS = dict(
    operation=1, mode=1, hrg_eos=1, set_FO_temperature=0, T_switch=0.151,
    df_mode=1, include_baryon=0, include_bulk_deltaf=1,
    include_shear_deltaf=1, include_baryondiff_deltaf=0, regulate_deltaf=0,
    outflow=1, group_particles=0, do_resonance_decays=0)


def write_synthetic_run_dir(path: str, n_cells: int, n_species: int,
                            dimension: int, seed: int = 0,
                            params: dict | None = None) -> str:
    """Write a complete mode-1 run directory under ``path``:

    * ``PDG/pdg-urqmd_v3.3+.dat`` (conventional format, every species
      stable) and ``PDG/chosen_particles_urqmd_v3.3+.dat`` selecting
      exactly ``n_species`` species (counted after baryon mirroring);
    * ``deltaf_coefficients/vh/urqmd/*.dat`` from the delta-f generator
      on that list, with two muB rows;
    * ``input/surface.dat``: ``n_cells`` synthetic cells in the mode-1
      layout (thermodynamic columns divided by hbarC);
    * ``iS3D_parameters.dat`` (operation 1, mode 1, ``dimension``; ``params``
      overrides any key).

    There is no ``tables/``, so runs use the native momentum grid."""
    from .io import pdg as pdg_io
    from .tools import deltaf_generator

    rng = np.random.default_rng(seed)
    pdg_dir = os.path.join(path, "PDG")
    os.makedirs(pdg_dir, exist_ok=True)
    rows = _pdg_entries(n_species, rng)
    _write_pdg(os.path.join(pdg_dir, "pdg-urqmd_v3.3+.dat"), rows)
    with open(os.path.join(pdg_dir, "chosen_particles_urqmd_v3.3+.dat"),
              "w") as f:
        f.write("".join(f"{m}\n" for m in _chosen_mcids(rows, n_species)))

    table = pdg_io.read_resonances(pdg_dir, 1)
    T, muB, tables = deltaf_generator.compute_coefficient_tables(table, nmuB=2)
    deltaf_generator.write_tables(
        T, muB, tables, os.path.join(path, "deltaf_coefficients", "vh", "urqmd"))

    cells = synthetic_surface_cells(n_cells, dimension, seed)
    order = ["tau", "x", "y", "eta", "dat", "dax", "day", "dan",
             "ux", "uy", "un"]
    raw = [cells[k] for k in order]
    raw += [cells[k] / HBARC for k in ("E", "T", "P", "pixx", "pixy", "pixn",
                                       "piyy", "piyn", "bulkPi")]
    os.makedirs(os.path.join(path, "input"), exist_ok=True)
    np.savetxt(os.path.join(path, "input", "surface.dat"),
               np.stack(raw, axis=1), fmt="%.10e")

    run_params = {**_RUN_PARAMS, "dimension": dimension, **(params or {})}
    with open(os.path.join(path, "iS3D_parameters.dat"), "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in run_params.items()))
    return path
