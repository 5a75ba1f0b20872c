"""Synthetic fixtures: surfaces, species lists, delta-f data, and a complete
run directory, all made from a numpy seed.

The repository ships no PDG or delta-f data, so these are what the tests
and ``chip_smoke.py`` drive.  Magnitudes mimic a realistic (2+1)D / (3+1)D
freeze-out surface near T ~ 0.155 GeV.
"""

from __future__ import annotations

import dataclasses
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
                            seed: int = 0, scale_bulk: float = 1.0) -> dict:
    """Random but physical freeze-out cells (numpy dict of columns).
    ``scale_bulk`` multiplies bulkPi: the modified equilibrium df (df 3-4)
    breaks down where bulk (and shear) are strong for the coefficient
    tables (FEQMOD_EDGES)."""
    rng = np.random.default_rng(seed)
    n = n_cells
    cells = dict(
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
    cells["bulkPi"] = cells["bulkPi"] * scale_bulk
    return cells


def synthetic_vorticity(n_cells: int, seed: int = 0) -> dict:
    """The six thermal-vorticity components of a mode-5 surface
    (dimensionless, O(0.05))."""
    rng = np.random.default_rng([seed, 5])
    return {k: rng.normal(0, 0.05, n_cells)
            for k in ("wtx", "wty", "wtn", "wxy", "wxn", "wyn")}


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

def _pdg_entries(n_species: int, rng, drng=None) -> list:
    """PDG rows (mcid, name, mass, width, gspin, baryon, strange, charge,
    channels) whose table holds at least ``n_species`` chosen species once
    the reader has mirrored the baryons: the seed hadrons, then
    resonance-like entries alternating meson and baryon.  Given ``drng``
    (the decaying list), the named resonances of _DECAY_NAMED come after
    the seed hadrons and the fillers decay, their channels drawn from
    ``drng`` (the fillers' masses and degeneracies come from ``rng`` as
    without it).  A channel is (branch, daughter mcids); a row without
    channels is stable."""
    decays = drng is not None
    rows = []
    for mcid, (mass, _sign, deg, baryon) in zip(_SEED_MCIDS, _SPECIES_SEED):
        if mcid < 0 and baryon != 0:
            continue                       # antibaryon: mirrored by the reader
        name, strange, charge = _SEED_PDG[mcid]
        width, channels = (_DECAY_SEED.get(mcid, (0.0, [])) if decays
                           else (0.0, []))
        rows.append((mcid, name, mass, width, deg, int(baryon), strange,
                     charge, channels))
    if decays:
        rows += [r[:8] + ([(b, d) for b, d in r[8]],) for r in _DECAY_NAMED]
    count = lambda: sum(2 if r[5] > 0 else 1 for r in rows)
    want = n_species + (len(_UNCHOSEN) if decays else 0)
    i = len(_SPECIES_SEED)
    while count() < want:
        mass = 1.0 + 0.005 * i + 0.1 * rng.random()
        deg = float(rng.integers(1, 6))
        baryon = 0 if i % 2 else 1
        mcid = (9000000 if i % 2 else 9100000) + i
        name = f"meson{i}" if i % 2 else f"baryon{i}"
        channels = (_filler_channels(rows, mass, baryon, drng) if decays
                    else [])
        width = 0.05 + 0.3 * drng.random() if channels else 0.0
        rows.append((mcid, name, mass, width, deg, baryon, 0, 0, channels))
        i += 1
    return rows


# The decaying list (write_synthetic_run_dir(..., decays=True)): the seed
# hadrons with rho0 and Delta++ unstable, a photon, an eta that is listed
# but never chosen, named resonances whose channels cover what the
# feed-down cascade must handle, and fillers that decay into lighter
# listed hadrons.  Named channels, (branch, daughters):
#   rho3 -> f2 pi0, f2 -> rho0 rho0, rho0 -> pi+ pi-: three waves deep;
#   f2 -> rho0 rho0: two identical daughters, below threshold at the
#     table masses and opened by the width shift;
#   h1 -> f2 pi0: below threshold too, and h1 is lighter than f2, so a
#     lighter parent feeds a heavier one (upward feed);
#   omega -> pi0 gamma, eta' -> rho0 gamma, omega gamma: massless
#     daughters;
#   omega -> pi+ pi- pi0, rho3 -> omega pi+ pi-: 3-body channels;
#     eta' -> eta pi+ pi- and eta pi0 pi0: with the unchosen eta and with
#     two identical daughters; omega -> K+ K- pi0: closed at the table
#     masses (skipped).
_DECAY_SEED = {113: (0.149, [(1.0, (211, -211))]),
               2224: (0.117, [(1.0, (2212, 211))])}
_DECAY_NAMED = [
    (22, "gamma", 0.0, 0.0, 2.0, 0, 0, 0, []),
    (221, "eta", 0.547862, 0.0, 1.0, 0, 0, 0, []),
    (223, "omega", 0.78265, 0.00849, 3.0, 0, 0, 0,
     [(0.892, (211, -211, 111)), (0.083, (111, 22)), (0.024, (211, -211)),
      (0.001, (321, -321, 111))]),
    (331, "eta'", 0.95778, 0.000188, 1.0, 0, 0, 0,
     [(0.426, (221, 211, -211)), (0.289, (113, 22)),
      (0.228, (221, 111, 111)), (0.057, (223, 22))]),
    (225, "f2", 1.2755, 0.1867, 5.0, 0, 0, 0,
     [(0.565, (211, -211)), (0.283, (111, 111)), (0.152, (113, 113))]),
    (10223, "h1", 1.166, 0.375, 3.0, 0, 0, 0,
     [(0.7, (113, 111)), (0.3, (225, 111))]),
    (117, "rho3", 1.6888, 0.161, 7.0, 0, 0, 0,
     [(0.5, (225, 111)), (0.3, (211, -211, 111)), (0.2, (223, 211, -211))]),
]
_UNCHOSEN = (221,)
# the fillers' channels: lighter named or seed hadrons, or a filler at
# least 0.3 GeV lighter with a pi0
_MESON_CHANNELS = [(211, -211), (111, 111), (321, -321), (113, 111),
                   (223, 111), (221, 111), (113, 113), (225, 111),
                   (211, -211, 111), (223, 211, -211), (111, 111, 111)]
_BARYON_CHANNELS = [(2212, 111), (2112, 111), (2212, -211), (3122, 321),
                    (2224, -211), (2212, 211, -211), (2112, 111, 111)]


def _filler_channels(rows: list, mass: float, baryon: int, rng) -> list:
    """1 to 3 channels of a filler of ``mass``, open at the table masses,
    into hadrons already in ``rows`` (the reader mirrors a baryon's
    channels from the rows above it); branches sum to 1 at 6 digits."""
    masses = {r[0]: r[2] for r in rows}
    masses.update({-r[0]: r[2] for r in rows if r[5] > 0})
    pool = [ds for ds in (_BARYON_CHANNELS if baryon else _MESON_CHANNELS)
            if sum(masses[d] for d in ds) < mass - 0.02]
    lighter = [r[0] for r in rows if r[0] >= 9000000 and r[5] == baryon
               and r[2] < mass - 0.3]
    if not pool:
        return []
    n = int(rng.integers(1, 4))
    picks = [pool[j] for j in rng.choice(len(pool), size=min(n, len(pool)),
                                         replace=False)]
    if lighter and rng.random() < 0.4:
        picks[-1] = (int(rng.choice(lighter)), 111)
    w = rng.random(len(picks)) + 0.2
    branch = [round(float(x), 6) for x in w / w.sum()]
    branch[-1] = round(1.0 - sum(branch[:-1]), 6)
    return list(zip(branch, picks))


def _write_pdg(path: str, rows: list):
    with open(path, "w") as f:
        for (mcid, name, mass, width, deg, baryon, strange, charge,
             channels) in rows:
            f.write(f"{mcid} {name} {mass:.6f} {width:.6f} {deg:.0f} "
                    f"{baryon} {strange} 0 0 1 {charge} "
                    f"{max(len(channels), 1)}\n")
            if not channels:
                # stable: one self-decay line (mcid, 1 daughter, branch 1)
                f.write(f"{mcid} 1 1.000000 {mcid} 0 0 0 0\n")
            for branch, ds in channels:
                d = " ".join(str(m) for m in (*ds, 0, 0, 0, 0)[:5])
                f.write(f"{mcid} {len(ds)} {branch:.6f} {d}\n")


def _chosen_mcids(rows: list, n_species: int) -> list:
    table = []
    for r in rows:
        if r[0] not in _UNCHOSEN:
            table.append(r[0])
            if r[5] > 0:
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


def synthetic_vah_cells(n_cells: int, dimension: int = 2, seed: int = 0,
                        pl_over_p=(0.3, 2.5)) -> dict:
    """Anisotropic-hydro cells (numpy columns, GeV units): the viscous
    cells of ``synthetic_surface_cells`` with the full pi_perp^munu, W^mu,
    PL / PT, and (a_L, Lambda) from PL/P (uniform in ``pl_over_p``; the
    default spans a_L from 0.40 to 4.3) by the conformal fit, as the mode-2
    reader infers them; a_T = 1."""
    from .physics.anisotropic import aL_fit, R200
    cells = synthetic_surface_cells(n_cells, dimension, seed)
    rng = np.random.default_rng([seed, 2])
    n = n_cells
    for k in ("pitt", "pitx", "pity", "pitn", "pinn"):
        cells[k] = rng.normal(0, 0.002, n)
    cells.update(Wt=rng.normal(0, 0.002, n), Wx=rng.normal(0, 0.002, n),
                 Wy=rng.normal(0, 0.002, n), Wn=rng.normal(0, 0.0005, n))
    cells["PL"] = cells["P"] * rng.uniform(*pl_over_p, n)
    cells["PT"] = (3.0 * cells["P"] - cells["PL"]) / 2.0
    aL = aL_fit(cells["PL"] / cells["P"])
    cells.update(aL=aL, aT=np.ones(n),
                 Lambda=cells["T"] / (0.5 * aL * R200(aL)) ** 0.25)
    return cells


def synthetic_vah_coefficients(cells: dict, seed: int = 0) -> dict:
    """Per-cell VAH residual-df coefficients c0..c4 whose df reaches O(1)
    on these surfaces (the clip bites with regulate on)."""
    rng = np.random.default_rng([seed, 3])
    n = cells["tau"].shape[0]
    return {f"c{i}": rng.normal(0, 30.0, n) for i in range(5)}


def _surface_rows(cells: dict, mode: int) -> np.ndarray:
    """(n_cells, columns) of a surface file in the reference layout of
    ``mode`` (1, 2, 3 or 5), thermodynamic columns divided by hbarC."""
    u = [cells[k] for k in ("ux", "uy", "un")]
    ut = np.sqrt(1.0 + u[0] ** 2 + u[1] ** 2 + (cells["tau"] * u[2]) ** 2)
    head = [cells[k] for k in ("tau", "x", "y", "eta", "dat", "dax", "day",
                               "dan")]
    g = lambda *ks: [cells[k] / HBARC for k in ks]
    if mode in (2, 3):
        pi_W = g("pitt", "pitx", "pity", "pitn", "pixx", "pixy", "pixn",
                 "piyy", "piyn", "pinn", "Wt", "Wx", "Wy", "Wn")
    if mode == 2:
        cols = head + [ut] + u + g("E", "T", "P", "PL") + pi_W + g("bulkPi")
    elif mode == 3:
        cols = (head + [ut] + u + g("E", "T", "PL", "PT") + pi_W
                + g("Lambda") + [cells["aT"], cells["aL"]])
    else:
        cols = head + u + g("E", "T", "P", "pixx", "pixy", "pixn", "piyy",
                            "piyn", "bulkPi")
        if mode == 5:
            cols += [cells[k] for k in ("wtx", "wty", "wtn", "wxy", "wxn",
                                        "wyn")]
    return np.stack(cols, axis=1)


def write_vah_coefficient_tables(path: str, seed: int = 0) -> str:
    """Write synthetic ``deltaf_coefficients/vah/c{0..4}_vah1.dat`` under
    the run directory ``path`` in the reference's layout (two header
    counts nL, naL, a label line, then (Lambda [fm^-1], aL, c) rows with
    Lambda fastest): smooth functions on Lambda in [0.6, 1.25] fm^-1 and
    a_L in [0.2, 2.0], of the magnitude synthetic_vah_coefficients
    gives once divided by hbarC^3."""
    rng = np.random.default_rng([seed, 4])
    L = np.linspace(0.6, 1.25, 14)
    aL = np.linspace(0.2, 2.0, 19)
    d = os.path.join(path, "deltaf_coefficients", "vah")
    os.makedirs(d, exist_ok=True)
    for i in range(5):
        a, b, c = rng.normal(0, 1, 3)
        vals = (30.0 * HBARC ** 3 * (a + b * np.sin(3.0 * L)[None, :]
                                     + c * aL[:, None] ** 2))
        rows = np.stack([np.broadcast_to(L[None, :], vals.shape),
                         np.broadcast_to(aL[:, None], vals.shape), vals],
                        axis=-1).reshape(-1, 3)
        with open(os.path.join(d, f"c{i}_vah1.dat"), "w") as f:
            f.write(f"{len(L)}\n{len(aL)}\nLambda[fm^-1] aL c{i}\n")
            np.savetxt(f, rows, fmt="%.10e")
    return path


def write_surface_file(path: str, n_cells: int, dimension: int,
                       seed: int = 0, mode: int = 1,
                       scale_bulk: float = 1.0) -> str:
    """A surface file of ``n_cells`` synthetic cells in the reference
    layout of ``mode`` (write_synthetic_run_dir's input/surface.dat)."""
    if mode in (2, 3):
        cells = synthetic_vah_cells(n_cells, dimension, seed)
    elif mode in (1, 5):
        cells = synthetic_surface_cells(n_cells, dimension, seed)
        if mode == 5:
            cells.update(synthetic_vorticity(n_cells, seed))
    else:
        raise ValueError(f"write_synthetic_run_dir writes modes 1, 2, 3 "
                         f"and 5, got {mode}")
    cells["bulkPi"] = cells["bulkPi"] * scale_bulk
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, _surface_rows(cells, mode), fmt="%.10e")
    return path


def write_momentum_tables(run_dir: str, n_pT: int = 6, n_phi: int = 5,
                          n_y: int = 5, n_eta: int = 10) -> str:
    """A small ``tables/`` under ``run_dir`` in the reference's file
    layout (Gauss-Legendre pT on [0, 4] and phi, trapezoid y on [-5, 5],
    Gauss-Legendre eta on [-7, 7] under both eta names), so that a run
    takes this narrow grid in place of the native one."""
    from .io.tables import gauss_legendre
    d = os.path.join(run_dir, "tables")
    os.makedirs(os.path.join(d, "eta"), exist_ok=True)
    yv = np.linspace(-5.0, 5.0, n_y)
    yw = np.full(n_y, yv[1] - yv[0])
    yw[[0, -1]] *= 0.5
    blocks = {"pT_gauss_legendre_table.dat": gauss_legendre(n_pT, 0.0, 4.0),
              "phi_gauss_legendre_table.dat":
                  gauss_legendre(n_phi, 0.0, 2.0 * np.pi),
              "y_trapezoid_table_21pt.dat": (yv, yw)}
    eta = gauss_legendre(n_eta, -7.0, 7.0)
    for name in ("eta_trapezoid_table_41pt.dat",
                 "eta_trapezoid_table_241pt.dat"):
        blocks[os.path.join("eta", name)] = eta
    for name, (x, w) in blocks.items():
        np.savetxt(os.path.join(d, name), np.stack([x, w], 1), fmt="%.17e")
    return run_dir


def write_synthetic_run_dir(path: str, n_cells: int, n_species: int,
                            dimension: int, seed: int = 0,
                            params: dict | None = None,
                            decays: bool = False,
                            scale_bulk: float = 1.0, mode: int = 1) -> str:
    """Write a complete run directory under ``path``:

    * ``PDG/pdg-urqmd_v3.3+.dat`` (conventional format, every species
      stable; with ``decays`` the decaying list of _DECAY_NAMED, whose
      run parameters set do_resonance_decays = 1) and
      ``PDG/chosen_particles_urqmd_v3.3+.dat`` selecting exactly
      ``n_species`` species (counted after baryon mirroring);
    * ``deltaf_coefficients/vh/urqmd/*.dat`` from the delta-f generator
      on that list, with two muB rows;
    * ``input/surface.dat``: ``n_cells`` synthetic cells in the reference
      layout of ``mode`` (thermodynamic columns divided by hbarC; bulkPi x
      ``scale_bulk``): 1 viscous hydro; 2 and 3 anisotropic hydro
      (synthetic_vah_cells: PL/P in [0.3, 2.5]; mode 3 carries Lambda,
      a_T and a_L, mode 2's reader infers them); 5 viscous hydro and the
      six thermal-vorticity components;
    * ``iS3D_parameters.dat`` (operation 1, ``mode``, ``dimension``;
      ``params`` overrides any key).

    There is no ``tables/``, so runs use the native momentum grid."""
    from .io import pdg as pdg_io
    from .tools import deltaf_generator

    rng = np.random.default_rng(seed)
    pdg_dir = os.path.join(path, "PDG")
    os.makedirs(pdg_dir, exist_ok=True)
    rows = _pdg_entries(n_species, rng,
                        np.random.default_rng([seed, 1]) if decays else None)
    _write_pdg(os.path.join(pdg_dir, "pdg-urqmd_v3.3+.dat"), rows)
    with open(os.path.join(pdg_dir, "chosen_particles_urqmd_v3.3+.dat"),
              "w") as f:
        f.write("".join(f"{m}\n" for m in _chosen_mcids(rows, n_species)))

    table = pdg_io.read_resonances(pdg_dir, 1)
    T, muB, tables = deltaf_generator.compute_coefficient_tables(table, nmuB=2)
    deltaf_generator.write_tables(
        T, muB, tables, os.path.join(path, "deltaf_coefficients", "vh", "urqmd"))

    write_surface_file(os.path.join(path, "input", "surface.dat"), n_cells,
                       dimension, seed, mode, scale_bulk)

    run_params = {**_RUN_PARAMS, "dimension": dimension, "mode": mode,
                  "do_resonance_decays": int(decays), **(params or {})}
    with open(os.path.join(path, "iS3D_parameters.dat"), "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in run_params.items()))
    return path


# ------------------------------------------------------- kernel edge cases

# The spectra kernel's edges, shared by the gpu tests and chip_smoke.py:
# species, momentum points and nodes that are not multiples of its blocking
# (4 species x 3 nodes, 128 points a block), 3+1D rapidities far enough
# from the cells that exp(u.p/T) overflows, light bosons at small mT, and
# large shear with the clip on.  Shear and bulk df are on, and regulate and
# outflow unless a case turns them off.  The 2d_remap cases take the 2+1D
# mT remap (a thread per (species, pT) for 8, 16 or 24 angles, 12 nodes a
# block in register blocks of 3, cells in tiles of 8): ragged shapes; flow
# rapidities |y_flow| up to 2 (u^eta scaled); light bosons whose mT straddles
# T_ref, where s(mT) clamps to 1; the clip; eta nodes shifted so far out
# that exp(u.p/T) overflows at every node for the lightest species
# (outputs exactly 0) and at no node for the heaviest; pad rows.
_RAGGED = dict(n_pT=11, n_phi=13, n_y=5, n_eta=13)
_REMAP = dict(eta_mT_rescale=True)
SPECTRA_EDGES = {
    **{f"{d}d_df{df}_ragged": dict(dimension=d, df_mode=df, n_species=41,
                                   grid=_RAGGED)
       for d in (3, 2) for df in (2, 1)},
    "3d_overflow": dict(dimension=3, df_mode=2, reg_out=0,
                        grid=dict(n_y=7, y_max=12.0)),
    "3d_light_bosons": dict(dimension=3, df_mode=2, light_bosons=True,
                            grid=dict(pT_max=0.2)),
    "3d_clip": dict(dimension=3, df_mode=2, scale_pi=30.0),
    **{f"2d_remap_df{df}_ragged": dict(dimension=2, df_mode=df, n_species=41,
                                       grid=dict(_RAGGED, **_REMAP))
       for df in (2, 1)},
    "2d_remap_yflow": dict(dimension=2, df_mode=2, scale_un=7.0, grid=_REMAP),
    "2d_remap_light_bosons": dict(dimension=2, df_mode=2, light_bosons=True,
                                  grid=dict(_REMAP, pT_max=0.2)),
    "2d_remap_clip": dict(dimension=2, df_mode=2, scale_pi=30.0, grid=_REMAP),
    "2d_remap_overflow": dict(dimension=2, df_mode=2, reg_out=0,
                              eta_shift=15.0, grid=_REMAP),
    "2d_remap_pad_rows": dict(dimension=2, df_mode=1, n_cells=37,
                              grid=_REMAP),
    # one species: the remap backward stages its one tile (a species' G
    # and node table) and no second
    "2d_remap_one_species": dict(dimension=2, df_mode=2, n_species=1,
                                 n_cells=6, grid=_REMAP),
    # the fixed-node backward's (K9a) stages and tail: one species; 151
    # species at 41 nodes, more than two stages of float32 or float64 hold
    # (two species chunks, the last one short); 7 angles, which no angle
    # group of 2 or 4 divides; 3200 rows at 21 nodes, more than one wave of
    # the 6-cell blocks on a 132-SM card, which do not divide them (the
    # last block partly empty); 70 fixed 2+1D nodes
    "3d_one_species": dict(dimension=3, df_mode=2, n_species=1, n_cells=6),
    "3d_species_chunks": dict(dimension=3, df_mode=2, n_species=151,
                              n_cells=40, grid=dict(n_y=41)),
    "3d_phi_tail": dict(dimension=3, df_mode=1, grid=dict(n_phi=7)),
    "3d_partial_block": dict(dimension=3, df_mode=2, n_cells=3190,
                             grid=dict(n_y=21)),
    "2d_fixed_many_nodes": dict(dimension=2, df_mode=2, n_cells=60,
                                grid=dict(n_eta=70)),
}


def edge_spec(edges: dict, case: str, n_cells: int = 203,
              n_species: int = 7) -> dict:
    """The settings of an edge case with every default filled in."""
    return dict(dict(n_cells=n_cells, n_species=n_species, reg_out=1, grid={},
                     light_bosons=False, scale_pi=1.0, scale_un=1.0,
                     eta_shift=0.0, rows=None),
                **edges[case])


def edge_config_kw(spec: dict) -> dict:
    """Config settings of an edge case (shear and bulk df on)."""
    return dict(mode=1, dimension=spec["dimension"], df_mode=spec["df_mode"],
                include_shear_deltaf=1, include_bulk_deltaf=1,
                regulate_deltaf=spec["reg_out"], outflow=spec["reg_out"])


def edge_grid_kw(spec: dict) -> dict:
    return dict(dict(n_pT=8, n_phi=6, n_y=5, n_eta=12, eta_mT_rescale=False),
                **spec["grid"])


def edge_grid(spec: dict, dtype, device):
    """The native momentum grid of an edge case, its eta nodes shifted by
    ``eta_shift``."""
    from .io.tables import native_momentum_grid
    grid = native_momentum_grid(spec["dimension"], dtype=dtype, device=device,
                                **edge_grid_kw(spec))
    if spec["eta_shift"]:
        grid = dataclasses.replace(grid, eta=grid.eta + spec["eta_shift"])
    return grid


def edge_surface_cells(spec: dict) -> dict:
    """The numpy cell columns of an edge case (seed 7, shear and u^eta
    scaled)."""
    cells = synthetic_surface_cells(spec["n_cells"], spec["dimension"],
                                    seed=7)
    for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        cells[k] = cells[k] * spec["scale_pi"]
    cells["un"] = cells["un"] * spec["scale_un"]
    return cells


def _edge_inputs(spec: dict, operation: int, dtype, device):
    """(packed cells, mom, flags, grid, cfg) of an edge case."""
    import dataclasses
    from .config import Config
    from .kernels import smooth
    from .kernels.common import surface_columns, prepare_cells
    dimension = spec["dimension"]
    cfg = Config(operation=operation, **edge_config_kw(spec))
    surface = surface_from_arrays(dtype=dtype, device=device,
                                  **edge_surface_cells(spec))
    grid = edge_grid(spec, dtype, device)
    species = synthetic_species(spec["n_species"], dtype=dtype, device=device)
    if spec["light_bosons"]:
        species = dataclasses.replace(species, mass=torch.where(
            species.sign < 0, torch.full_like(species.mass, 0.02),
            species.mass))
    df_data = synthetic_deltaf_data(dtype=dtype, device=device)
    packed = smooth.pack_cells(
        prepare_cells(surface_columns(surface, cfg), cfg, df_data), cfg)
    if spec["rows"] is not None:
        packed = packed[:spec["rows"]].contiguous()
    return (packed, smooth.momentum_constants(species, grid, dimension),
            smooth.spectra_flags(cfg, grid), grid, cfg)


def spectra_edge_inputs(case: str, n_cells: int = 203, n_species: int = 7,
                        dtype=torch.float64, device="cpu"):
    """(cells, mom, flags): the spectra kernel's packed inputs for the
    SPECTRA_EDGES case ``case``, on ``device``."""
    spec = edge_spec(SPECTRA_EDGES, case, n_cells, n_species)
    return _edge_inputs(spec, 1, dtype, device)[:3]


def spectra_edge_seen(case: str, cells, mom, flags, out) -> str:
    """What the plain spectra ``out`` of a SPECTRA_EDGES case show of the
    edge the case is named for; raises AssertionError where they do not
    show it."""
    import dataclasses
    from .kernels import smooth
    assert torch.isfinite(out).all() and out.abs().max() > 0, case
    assert flags.remap == case.startswith("2d_remap"), case
    S, M, R = mom.mass.shape[0], mom.px.shape[0], mom.nodes.shape[0]
    P, F = mom.pT.shape[0], mom.n_phi
    if case.endswith("ragged"):
        assert S % 4 and M % 128 and R % 3, (S, M, R)
        if flags.remap:
            assert (S * P) % 128 and R % 12 % 3, (S, P, R)
            assert F not in (8, 16, 24), F
        return f"{S} species x {M} points x {R} nodes"
    if case.endswith("overflow"):
        n = int((out == 0).sum())
        assert 0 < n < out.numel(), f"{n} outputs are exactly 0"
        return f"{n} of {out.numel()} outputs exactly 0"
    if case.endswith("light_bosons"):
        assert (mom.mass[mom.sign < 0] == 0.02).all()
        seen = f"bosons of mass 0.02, pT <= {mom.pT.max().item():.2f}"
        if flags.remap:
            s = smooth.remap_scale(mom)
            assert (s == 1).any() and (s < 1).any()
            seen += f", s(mT) = 1 at {int((s == 1).sum())} of {S * P}"
        return seen
    if case.endswith("yflow"):
        yflow = cells[:, smooth.IDX["yflow"]].abs().max().item()
        assert 1.5 < yflow < 2.5, yflow
        return f"|y_flow| up to {yflow:.2f}"
    if case.endswith("one_species"):
        assert S == 1, S
        return f"1 species, {SPECTRA_EDGES[case]['n_cells']} cells"
    if case.endswith("species_chunks"):
        # two float32 stages of every species (a species' 41 nodes x 2
        # angles and its row, 352 bytes) are more than the shared memory of
        # one of the 4 blocks an SM holds
        assert S % 2 and R == 41, (S, R)
        assert 2 * S * (R * 2 * 4 + 16) > 233472 // 4, S
        return f"{S} species x {R} nodes: two species chunks a stage"
    if case.endswith("phi_tail"):
        assert F % 2 and F % 4, F
        return f"{F} angles"
    if case.endswith("partial_block"):
        n = cells.shape[0]
        assert R == 21 and n % 6 and n > 6 * 4 * 132, (n, R)
        return f"{n} rows at {R} nodes"
    if case.endswith("many_nodes"):
        assert flags.dimension == 2 and R > 21, R
        return f"{R} fixed eta nodes"
    if case.endswith("pad_rows"):
        n = SPECTRA_EDGES[case]["n_cells"]
        assert cells.shape[0] > n
        pad = smooth.smooth_spectra_plain(cells[n:], mom, flags)
        assert (pad == 0).all()
        return f"{cells.shape[0] - n} pad rows of {cells.shape[0]} add 0"
    free = smooth.smooth_spectra_plain(cells, mom, dataclasses.replace(
        flags, regulate=False))
    moved = ((free - out).abs().max() / out.abs().max()).item()
    assert moved > 1e-3, f"the clip moves the output by only {moved:.2e}"
    return f"the clip moves the output by {moved:.2e} of its max"


# The dN/dX kernel's edges, shared by the tests and chip_smoke.py: species
# and nodes that are not multiples of its blocking (4 species x 3 nodes a
# thread) and rows that are not whole batches (128 threads over (cell,
# node group) pairs); fewer rows than one batch, exactly one row; 3+1D
# rapidities far enough from the cells that exp(u.p/T) overflows (dN/dy/
# deta exactly 0 there); light bosons at small mT; large shear with the
# clip on; pad rows (per_cell exactly 0).
DNDX_EDGES = {
    "2d_df1_ragged": dict(dimension=2, df_mode=1, n_species=41,
                          grid=_RAGGED),
    "3d_df2_ragged": dict(dimension=3, df_mode=2, n_species=41,
                          grid=_RAGGED),
    "2d_few_rows": dict(dimension=2, df_mode=1, n_cells=5),
    "2d_one_row": dict(dimension=2, df_mode=2, n_cells=3, rows=1),
    "3d_overflow": dict(dimension=3, df_mode=2, reg_out=0,
                        grid=dict(n_y=7, y_max=12.0)),
    "3d_light_bosons": dict(dimension=3, df_mode=1, light_bosons=True,
                            grid=dict(pT_max=0.2)),
    "2d_clip": dict(dimension=2, df_mode=2, scale_pi=30.0),
    "2d_pad_rows": dict(dimension=2, df_mode=1, n_cells=37),
}


def dndx_edge_inputs(case: str, n_cells: int = 203, n_species: int = 7,
                     dtype=torch.float64, device="cpu"):
    """(cells, mom, flags, wM, wR): the dN/dX kernel's inputs for the
    DNDX_EDGES case ``case``, on ``device``."""
    from .kernels import dndx
    spec = edge_spec(DNDX_EDGES, case, n_cells, n_species)
    packed, mom, flags, grid, cfg = _edge_inputs(spec, 0, dtype, device)
    return (packed, mom, flags, dndx.momentum_weights(grid, cfg),
            dndx.node_weights(grid, cfg.dimension))


def dndx_edge_seen(case: str, cells, mom, flags, wM, wR, per_cell,
                   dydeta) -> str:
    """What the plain outputs of a DNDX_EDGES case show of the edge the
    case is named for; raises AssertionError where they do not show it."""
    import dataclasses
    from .kernels import dndx
    assert torch.isfinite(per_cell).all() and torch.isfinite(dydeta).all()
    assert per_cell.abs().max() > 0 and dydeta.abs().max() > 0, case
    rows, S, R = cells.shape[0], mom.mass.shape[0], mom.nodes.shape[0]
    batch = dndx.cells_per_batch(R)
    if "ragged" in case:
        assert S % 4 and R % 3 and rows % batch, (S, R, rows, batch)
        return f"{rows} rows in batches of {batch} x {S} species x {R} nodes"
    if case in ("2d_few_rows", "2d_one_row"):
        assert rows < batch and (rows == 1) == (case == "2d_one_row")
        return f"{rows} rows, batches of {batch}"
    if case == "3d_overflow":
        n = int((dydeta == 0).sum())
        assert n > 0, "no dN/dy/deta value is exactly 0"
        return f"{n} dN/dy/deta values exactly 0"
    if case == "3d_light_bosons":
        assert (mom.mass[mom.sign < 0] == 0.02).all()
        return f"bosons of mass 0.02, pT <= {mom.pT.max().item():.2f}"
    if case == "2d_pad_rows":
        n = DNDX_EDGES[case]["n_cells"]
        assert rows > n and (per_cell[n:] == 0).all()
        assert (per_cell[:n] != 0).any()
        return f"{rows - n} pad rows of {rows} exactly 0"
    free = dndx.dndx_plain(cells, mom, dataclasses.replace(
        flags, regulate=False), wM, wR)[0]
    moved = ((free - per_cell).abs().max() / per_cell.abs().max()).item()
    assert moved > 1e-3, f"the clip moves per_cell by only {moved:.2e}"
    return f"the clip moves per_cell by {moved:.2e} of its max"


# The binning kernel's edges: (cells, bin settings) with empty bins, a bin
# of every cell, bins longer and shorter than one 64-entry slice.
BIN_EDGES = {"many_empty": (777, dict(tau_bins=30, r_bins=20)),
             "long_bins": (777, dict(tau_bins=3, r_bins=2)),
             "one_tau_bin": (1000, dict(tau_max=1000.0, tau_bins=2,
                                        r_max=1000.0, r_bins=1)),
             "one_slice": (64, dict(tau_bins=30, r_bins=20)),
             "few_cells": (5, dict(tau_bins=30, r_bins=20))}


def bin_edge_inputs(case: str, dtype=torch.float64, device="cpu"):
    """(per_cell (n, 41), plan): the binning kernel's inputs for the
    BIN_EDGES case ``case``, on ``device``."""
    from .config import Config
    from .kernels import dndx
    n, bins = BIN_EDGES[case]
    cells = synthetic_surface_cells(n, 2, seed=len(case))
    t = lambda k: torch.as_tensor(cells[k], dtype=dtype, device=device)
    plan = dndx.bin_plan(t("tau"), t("x"), t("y"), Config(operation=0,
                                                          **bins))
    per_cell = torch.as_tensor(np.random.default_rng(n).random((n, 41)),
                               dtype=dtype, device=device)
    return per_cell, plan


# The feqmod kernels' edges (df 3-4), shared by the gpu tests and
# chip_smoke.py.  Each case runs through the entry points of its path: 3+1D
# and 2+1D fixed nodes the fixed-node kernel and the dN/dX producer, the
# 2+1D remap the remap kernel.  The synthetic delta-f tables are far from
# a real gas's (betapi and betabulk ~100x small), so shear and bulk are
# scaled down to reach clean cells (scale_pi 0.01, scale_bulk 0.001: none
# break down), mixed ones (0.1, 0.01: 20-50 %) and mostly broken-down ones
# (0.3, 0.01: 75-90 %; df 3 by a negative pi0 density or detA, df 4 by
# detA).  Further: near-degenerate 3+1D cells (bulkPi = -0.9 P under df 4:
# detA in (0, 0.01)) with eta on the output rapidities, where the narrow
# mask takes the fallback; species, points and nodes that are not multiples
# of the blocking (4 species x 3 nodes, 128 points a block; the remap's
# 128 (species, pT) a block, 8, 16 or 24 angles, 12 nodes); exp overflow
# with exact zeros; the df 4 clamp (bulkPi < -P and above the Jonah
# table's bulkPi/P); reference_compat_feqmod_eta; a df 3 baryon case
# (alphaB_mod); degenerate tables (betaV = 0 with diffusion and
# regulation: the unregrouped fallback keeps the clipped +-inf finite);
# pad rows of the canonical group tree (inert, adding exactly 0).
_MOD = dict(scale_pi=0.01, scale_bulk=0.001)
_MIXED = dict(scale_pi=0.1, scale_bulk=0.01)
_MOST = dict(scale_pi=0.3, scale_bulk=0.01)
FEQMOD_EDGES = {
    "3d_df3_clean": dict(dimension=3, df_mode=3, **_MOD),
    "3d_df4_mixed": dict(dimension=3, df_mode=4, **_MIXED),
    "3d_df3_most": dict(dimension=3, df_mode=3, **_MOST),
    "3d_df4_narrow": dict(dimension=3, df_mode=4, scale_pi=0.01,
                          bulk_P=(-0.9,), eta_on_y=True),
    "3d_df3_ragged": dict(dimension=3, df_mode=3, n_species=41,
                          grid=_RAGGED, **_MIXED),
    "3d_overflow": dict(dimension=3, df_mode=4, reg_out=0,
                        grid=dict(n_y=7, y_max=12.0), **_MIXED),
    "3d_df4_clamp": dict(dimension=3, df_mode=4, scale_pi=0.01,
                         bulk_P=(-1.5, 0.2, 40.0)),
    "3d_df3_baryon": dict(dimension=3, df_mode=3, baryon=True, **_MIXED),
    "3d_degenerate": dict(dimension=3, df_mode=3, baryon=True, diff=True,
                          zero_betaV=True, **_MOST),
    "2d_df3_ragged": dict(dimension=2, df_mode=3, n_species=41,
                          grid=_RAGGED, **_MIXED),
    "2d_df4_most": dict(dimension=2, df_mode=4, **_MOST),
    "2d_df4_compat": dict(dimension=2, df_mode=4, compat=1, scale_pi=0.01,
                          scale_bulk=3.0),
    "2d_pad_rows": dict(dimension=2, df_mode=3, n_cells=37, pad_to=48,
                        **_MIXED),
    "2d_remap_df3_mixed": dict(dimension=2, df_mode=3, grid=_REMAP, **_MIXED),
    "2d_remap_df4_most": dict(dimension=2, df_mode=4, grid=_REMAP, **_MOST),
    "2d_remap_df3_clean": dict(dimension=2, df_mode=3, grid=_REMAP, **_MOD),
    "2d_remap_ragged": dict(dimension=2, df_mode=4, n_species=41,
                            grid=dict(_RAGGED, **_REMAP), **_MIXED),
    "2d_remap_overflow": dict(dimension=2, df_mode=3, reg_out=0,
                              eta_shift=16.5, grid=_REMAP, **_MOD),
    "2d_remap_pad_rows": dict(dimension=2, df_mode=4, n_cells=37, pad_to=48,
                              grid=_REMAP, **_MIXED),
}


def feqmod_edge_spec(case: str, n_cells: int = 203,
                     n_species: int = 7) -> dict:
    """A FEQMOD_EDGES case with every default filled in."""
    spec = dict(dict(scale_bulk=1.0, bulk_P=None, eta_on_y=False,
                     baryon=False, diff=False, zero_betaV=False, compat=0,
                     pad_to=None),
                **edge_spec(FEQMOD_EDGES, case, n_cells, n_species))
    return spec


def feqmod_edge_inputs(case: str, n_cells: int = 203, n_species: int = 7,
                       dtype=torch.float64, device="cpu"):
    """(x, rn, wcs, mom, flags, wM, wR): the feqmod kernels' inputs for the
    FEQMOD_EDGES case ``case`` on ``device``, and the dN/dX weights of its
    grid."""
    from .config import Config
    from .io.tables import laguerre_device
    from .kernels import feqmod, dndx
    from .kernels.common import surface_columns
    from .kernels.smooth import momentum_constants
    from .parallel.mesh import _pad_inert
    spec = feqmod_edge_spec(case, n_cells, n_species)
    dim = spec["dimension"]
    cfg = Config(operation=1, **edge_config_kw(spec),
                 include_baryon=int(spec["baryon"]),
                 include_baryondiff_deltaf=int(spec["diff"]),
                 reference_compat_feqmod_eta=spec["compat"])
    grid = edge_grid(spec, dtype, device)
    cells = edge_surface_cells(spec)
    cells["bulkPi"] = cells["bulkPi"] * spec["scale_bulk"]
    if spec["bulk_P"] is not None:
        f = np.resize(np.asarray(spec["bulk_P"], float), spec["n_cells"])
        cells["bulkPi"] = f * cells["P"]
    if spec["eta_on_y"]:
        y = grid.y.cpu().numpy()
        cells["eta"] = y[np.abs(cells["eta"][:, None] - y[None, :])
                         .argmin(1)]
    if spec["baryon"]:
        rng = np.random.default_rng(spec["n_cells"])
        n = spec["n_cells"]
        cells.update(muB=rng.uniform(0.05, 0.3, n),
                     nB=rng.uniform(0.01, 0.05, n))
        if spec["diff"]:
            cells.update(Vx=rng.normal(0, 0.02, n), Vy=rng.normal(0, 0.02, n),
                         Vn=rng.normal(0, 0.005, n))
    surface = surface_from_arrays(dtype=dtype, device=device, **cells)
    species = synthetic_species(spec["n_species"], dtype=dtype,
                                device=device)
    df_data = synthetic_deltaf_data(dtype=dtype, device=device)
    if spec["zero_betaV"]:
        tables = dict(df_data.tables, betaV=torch.zeros_like(
            df_data.tables["betaV"]))
        df_data = dataclasses.replace(df_data, tables=tables)
    flags = feqmod.feqmod_flags(cfg, grid)
    cols = surface_columns(surface, cfg)
    if spec["pad_to"] is not None:
        cols = _pad_inert(cols, spec["pad_to"])
    x, rn, wcs = feqmod.group_inputs(
        cols, species, laguerre_device(dtype=dtype, device=device), df_data,
        cfg, flags)
    return (x, rn, wcs, momentum_constants(species, grid, dim), flags,
            dndx.momentum_weights(grid, cfg), dndx.node_weights(grid, dim))


def feqmod_edge_seen(case: str, x, rn, wcs, mom, flags, out) -> str:
    """What the plain spectra ``out`` of a FEQMOD_EDGES case show of the
    edge the case is named for; raises AssertionError where they do not
    show it."""
    from .kernels import feqmod, smooth
    assert torch.isfinite(out).all() and out.abs().max() > 0, case
    assert flags.remap == ("remap" in case), case
    spec = feqmod_edge_spec(case)
    bd = x[:, feqmod.FQ["bd"]] > 0
    share = f"{int(bd.sum())} of {x.shape[0]} cells break down"
    S, M, R = mom.mass.shape[0], mom.px.shape[0], mom.nodes.shape[0]
    P, F = mom.pT.shape[0], mom.n_phi
    if case.endswith("ragged"):
        assert S % 4 and M % 128 and R % 3, (S, M, R)
        if flags.remap:
            assert (S * P) % 128 and R % 12 % 3 and F not in (8, 16, 24)
        return f"{S} species x {M} points x {R} nodes; {share}"
    if case.endswith("overflow"):
        n = int((out == 0).sum())
        assert 0 < n < out.numel(), f"{n} outputs are exactly 0"
        return f"{n} of {out.numel()} outputs exactly 0"
    if case.endswith("one_species"):
        assert S == 1, S
        return f"1 species, {SPECTRA_EDGES[case]['n_cells']} cells"
    if case.endswith("pad_rows"):
        n = spec["n_cells"]
        assert x.shape[0] > n
        pad = feqmod.feqmod_spectra_plain(x[n:], rn[n:], wcs[n:], mom, flags)
        assert (pad == 0).all()
        return f"{x.shape[0] - n} pad rows of {x.shape[0]} add 0"
    if case.endswith("narrow"):
        detA = x[:, feqmod.FQ["detA"]]
        narrow = (~bd) & (detA > 0) & (detA < feqmod.NARROW_DETA)
        assert narrow.sum() > 0
        return (f"{int(narrow.sum())} cells with 0 < detA < 0.01 on the "
                f"output rapidities; {share}")
    if case.endswith("clamp"):
        return f"bulkPi at -1.5 P and 40 P clamped into the Jonah table"
    if case.endswith("compat"):
        scale = x[:, feqmod.FQ["scale"]]
        detA = x[:, feqmod.FQ["detA"]]
        assert ((detA >= 1) & (scale == 1)).any() and (scale < 1).any()
        return (f"{int((detA >= 1).sum())} cells with detA >= 1 keep eta "
                f"unscaled; {share}")
    if case.endswith("baryon"):
        assert x[:, feqmod.FQ["abm"]].abs().max() > 0
        return f"alphaB_mod up to {x[:, feqmod.FQ['abm']].abs().max():.3f}"
    if case.endswith("degenerate"):
        assert torch.isinf(x[:, feqmod.FQ["kV"]]).all() and bd.any()
        return f"1/betaV = inf on every cell; {share}"
    if case.endswith("clean"):
        assert not bd.any()
    elif case.endswith("most"):
        assert bd.float().mean() > 0.7
    else:
        assert bd.any() and not bd.all()
    return share


# ------------------------------------------------- VAH and polarization

# The VAH kernels' edges (K4: fixed_kernel, remap_kernel and the dN/dX
# producer), shared by the gpu tests and chip_smoke.py.  Every chain
# setting (sw: shear 1, bulk 2) on each path; regulate and outflow off
# (reg_out 0) and on; ragged species, points and nodes; a_L below and
# above 1 only (PL/P in [0.3, 0.9] or [1.2, 2.5]); strong longitudinal
# flow (u^eta x 7, |y_flow| up to 2); 3+1D rapidities and 2+1D eta nodes
# far enough out that exp overflows (exact zeros; in 2+1D the nodes in a
# narrow window at eta 8-9 and a_L near 1, so that the light species
# overflow in float64 at every node and the heavy ones, whose remap scale
# s is a third of theirs, stay above float32's smallest normal); pad rows
# of the
# canonical group tree (inert, adding exactly 0).  The c0..c4 columns are
# synthetic_vah_coefficients' where a chain is on, absent where not.
VAH_EDGES = {
    **{f"3d_sw{sw}": dict(dimension=3, sw=sw) for sw in range(4)},
    "3d_sw3_plain": dict(dimension=3, sw=3, reg_out=0),
    "3d_ragged": dict(dimension=3, sw=3, n_species=41, grid=_RAGGED),
    "3d_overflow": dict(dimension=3, sw=0, reg_out=0,
                        grid=dict(n_y=7, y_max=12.0)),
    "3d_aL_below_1": dict(dimension=3, sw=1, pl_over_p=(0.3, 0.9)),
    **{f"2d_fixed_sw{sw}": dict(dimension=2, sw=sw) for sw in (0, 3)},
    "2d_fixed_ragged": dict(dimension=2, sw=2, n_species=41, grid=_RAGGED),
    **{f"2d_remap_sw{sw}": dict(dimension=2, sw=sw, grid=_REMAP)
       for sw in range(4)},
    "2d_remap_sw3_plain": dict(dimension=2, sw=3, reg_out=0, grid=_REMAP),
    "2d_remap_ragged": dict(dimension=2, sw=3, n_species=41,
                            grid=dict(_RAGGED, **_REMAP)),
    "2d_remap_phi24": dict(dimension=2, sw=1, grid=dict(_REMAP, n_phi=24)),
    "2d_remap_aL_above_1": dict(dimension=2, sw=0, pl_over_p=(1.2, 2.5),
                                grid=_REMAP),
    "2d_remap_yflow": dict(dimension=2, sw=3, scale_un=7.0, grid=_REMAP),
    "2d_remap_overflow": dict(dimension=2, sw=0, reg_out=0, eta_shift=8.5,
                              pl_over_p=(0.9, 1.1),
                              grid=dict(_REMAP, eta_max=0.5)),
    "2d_remap_pad_rows": dict(dimension=2, sw=3, n_cells=37, pad_to=48,
                              grid=_REMAP),
}


def vah_edge_spec(case: str, n_cells: int = 203, n_species: int = 7) -> dict:
    """A VAH_EDGES case with every default filled in."""
    return dict(dict(pl_over_p=(0.3, 2.5), pad_to=None),
                **edge_spec(VAH_EDGES, case, n_cells, n_species))


def vah_edge_inputs(case: str, n_cells: int = 203, n_species: int = 7,
                    dtype=torch.float64, device="cpu"):
    """(x, mom, flags, wM, wR): the VAH kernels' packed inputs for the
    VAH_EDGES case ``case`` on ``device``, and the dN/dX weights of its
    grid (the dN/dX producer takes the fixed-node cases)."""
    from .config import Config
    from .kernels import vah, dndx
    from .kernels.smooth import momentum_constants
    from .parallel.mesh import _pad_inert
    spec = vah_edge_spec(case, n_cells, n_species)
    dim, sw = spec["dimension"], spec["sw"]
    cfg = Config(operation=1, mode=2, dimension=dim,
                 include_shear_deltaf=sw & 1, include_bulk_deltaf=sw >> 1,
                 regulate_deltaf=spec["reg_out"], outflow=spec["reg_out"])
    grid = edge_grid(spec, dtype, device)
    cells = synthetic_vah_cells(spec["n_cells"], dim, seed=7,
                                pl_over_p=spec["pl_over_p"])
    cells["un"] = cells["un"] * spec["scale_un"]
    if sw:
        cells.update(synthetic_vah_coefficients(cells, seed=7))
    surface = surface_from_arrays(dtype=dtype, device=device, **cells)
    cols = vah.vah_surface_cols(surface)
    if spec["pad_to"] is not None:
        cols = _pad_inert(cols, spec["pad_to"])
    flags = vah.vah_flags(vah.effective_vah_cfg(cols, cfg), grid)
    assert flags.switches == sw, (case, flags)
    species = synthetic_species(spec["n_species"], dtype=dtype,
                                device=device)
    return (vah.group_inputs(cols, flags),
            momentum_constants(species, grid, dim), flags,
            dndx.momentum_weights(grid, cfg), dndx.node_weights(grid, dim))


def vah_edge_seen(case: str, x, mom, flags, out) -> str:
    """What the plain spectra ``out`` of a VAH_EDGES case show of the edge
    the case is named for; raises AssertionError where they do not."""
    from .kernels import vah
    assert torch.isfinite(out).all() and out.abs().max() > 0, case
    assert flags.remap == ("remap" in case), case
    spec = vah_edge_spec(case)
    aL = x[:, vah.VF["aL"]]
    S, M, R = mom.mass.shape[0], mom.px.shape[0], mom.nodes.shape[0]
    if case.endswith("ragged"):
        assert S % 4 and M % 128 and R % 3, (S, M, R)
        return f"{S} species x {M} points x {R} nodes"
    if case.endswith("overflow"):
        n = int((out == 0).sum())
        assert 0 < n < out.numel(), f"{n} outputs are exactly 0"
        return f"{n} of {out.numel()} outputs exactly 0"
    if case.endswith("one_species"):
        assert S == 1, S
        return f"1 species, {SPECTRA_EDGES[case]['n_cells']} cells"
    if case.endswith("pad_rows"):
        n = spec["n_cells"]
        assert x.shape[0] > n
        pad = vah.vah_spectra_plain(x[n:], mom, flags)
        assert (pad == 0).all()
        return f"{x.shape[0] - n} pad rows of {x.shape[0]} add 0"
    if case.endswith("yflow"):
        yf = x[:, vah.VF["yflow"]].abs().max().item()
        assert yf > 1.0
        return f"|y_flow| up to {yf:.2f}"
    if case.endswith("below_1"):
        assert (aL < 1).all()
    elif case.endswith("above_1"):
        assert (aL > 1).all()
    else:
        assert (aL < 1).any() and (aL > 1).any()
    return (f"a_L in [{aL.min().item():.2f}, {aL.max().item():.2f}], "
            f"chains {flags.switches}, regulate/outflow {int(flags.regulate)}")


# The polarization kernels' edges (K6: fixed_kernel, remap_kernel): each
# path; ragged species, points and nodes (the remap takes 8 angles a
# thread); strong longitudinal flow; 3+1D rapidities far enough out that
# f0 is exactly 0 (exact zeros); a massless species, whose S sums are inf
# or NaN (pm = -0.25 / m = -inf) and must keep that pattern; pad rows.
POLZN_EDGES = {
    "3d": dict(dimension=3),
    "3d_ragged": dict(dimension=3, n_species=41, grid=_RAGGED),
    "3d_overflow": dict(dimension=3, grid=dict(n_y=7, y_max=12.0)),
    "3d_massless": dict(dimension=3, massless=True),
    "2d_fixed": dict(dimension=2),
    "2d_fixed_ragged": dict(dimension=2, n_species=41, grid=_RAGGED),
    "2d_remap": dict(dimension=2, grid=_REMAP),
    "2d_remap_ragged": dict(dimension=2, n_species=41,
                            grid=dict(_RAGGED, **_REMAP)),
    "2d_remap_yflow": dict(dimension=2, scale_un=7.0, grid=_REMAP),
    "2d_remap_massless": dict(dimension=2, massless=True, grid=_REMAP),
    "2d_remap_pad_rows": dict(dimension=2, n_cells=37, pad_to=48,
                              grid=_REMAP),
}
POLZN_T_AVG = 0.152


def polzn_edge_spec(case: str, n_cells: int = 203,
                    n_species: int = 7) -> dict:
    """A POLZN_EDGES case with every default filled in."""
    return dict(dict(massless=False, pad_to=None),
                **edge_spec(POLZN_EDGES, case, n_cells, n_species))


def polzn_edge_inputs(case: str, n_cells: int = 203, n_species: int = 7,
                      dtype=torch.float64, device="cpu", **override):
    """(x, mom, pm, wR, flags, table): the polarization kernels' inputs
    for the POLZN_EDGES case ``case`` on ``device`` (table: the remap's
    node table, else None); ``override`` replaces settings of the case
    (n_species, grid, ...)."""
    from .config import Config
    from .kernels import polzn
    from .kernels.smooth import momentum_constants, remap_node_table
    from .parallel.mesh import _pad_inert
    spec = dict(polzn_edge_spec(case, n_cells, n_species), **override)
    dim = spec["dimension"]
    cfg = Config(operation=1, mode=5, dimension=dim)
    grid = edge_grid(spec, dtype, device)
    cells = edge_surface_cells(spec)
    cells.update(synthetic_vorticity(spec["n_cells"], seed=7))
    surface = surface_from_arrays(dtype=dtype, device=device, **cells)
    species = synthetic_species(spec["n_species"], dtype=dtype,
                                device=device)
    if spec["massless"]:
        species = dataclasses.replace(species, mass=torch.where(
            torch.arange(spec["n_species"], device=device) == 2,
            torch.zeros_like(species.mass), species.mass))
    flags = polzn.polzn_flags(cfg, grid)
    cols = polzn.polzn_cols(surface)
    if spec["pad_to"] is not None:
        cols = _pad_inert(cols, spec["pad_to"])
    mom = momentum_constants(species, grid, dim)
    return (polzn.pack_polzn_cells(cols, POLZN_T_AVG, flags), mom,
            polzn.species_pm(species), polzn.node_weights(grid, flags), flags,
            remap_node_table(mom) if flags.remap else None)


def polzn_edge_seen(case: str, x, mom, pm, wR, flags, sums) -> str:
    """What the plain sums of a POLZN_EDGES case show of the edge the case
    is named for; raises AssertionError where they do not."""
    from .kernels import polzn
    spec = polzn_edge_spec(case)
    assert flags.remap == ("remap" in case), case
    snorm = sums[4]
    assert torch.isfinite(snorm).all() and snorm.abs().max() > 0, case
    finite = all(torch.isfinite(t).all() for t in sums[:4])
    if case.endswith("massless"):
        bad = sum(int((~torch.isfinite(t)).sum()) for t in sums[:4])
        assert not finite and bad > 0
        return f"{bad} non-finite S values (the massless species)"
    assert finite, case
    S, M, R = mom.mass.shape[0], mom.px.shape[0], mom.nodes.shape[0]
    if case.endswith("ragged"):
        assert S % 4 and M % 128 and R % 3, (S, M, R)
        return f"{S} species x {M} points x {R} nodes"
    if case.endswith("overflow"):
        n = int((snorm == 0).sum())
        assert 0 < n < snorm.numel(), f"{n} outputs are exactly 0"
        return f"{n} of {snorm.numel()} Snorm values exactly 0"
    if case.endswith("one_species"):
        assert S == 1, S
        return f"1 species, {SPECTRA_EDGES[case]['n_cells']} cells"
    if case.endswith("pad_rows"):
        n = spec["n_cells"]
        pad = polzn.polzn_plain(x[n:], mom, pm, wR, flags)
        assert all((t == 0).all() for t in pad)
        return f"{x.shape[0] - n} pad rows of {x.shape[0]} add 0"
    if case.endswith("yflow"):
        yf = x[:, polzn.PW["yflow"]].abs().max().item()
        assert yf > 1.0
        return f"|y_flow| up to {yf:.2f}"
    return f"{S} species x {M} points x {R} nodes"


# ------------------------------------------------------- decaying list

# The schedule of the decaying list that chip_smoke.py's [decays main] path
# runs (320 species, seed 0): its channel contributions and waves (the
# CLI's "Resonance decays: ..." line) and the waves with 2-body and with
# 3-body tasks (the wave kernel's launches of each body).
# tests/test_torch_decays.py holds is3d_tpu's own schedule of this list to
# these numbers, so the chip run checks the port's against an independent
# count.
DECAYS_MAIN_SCHEDULE = dict(n_species=320, seed=0, channel_contributions=1216,
                            waves=4, waves_2body=4, waves_3body=4)


def write_decaying_pdg(path: str, n_species: int, seed: int = 0):
    """Write, as the file ``path`` in pdg.dat's format, the decaying
    synthetic list that write_synthetic_run_dir(..., decays=True) writes
    for ``n_species`` and ``seed``; return its chosen mcids."""
    rows = _pdg_entries(n_species, np.random.default_rng(seed),
                        np.random.default_rng([seed, 1]))
    _write_pdg(path, rows)
    return np.asarray(_chosen_mcids(rows, n_species), np.int64)


def synthetic_decaying_table(n_species: int, seed: int = 0):
    """(ParticleTable, chosen mcids) of the decaying synthetic list
    (write_decaying_pdg), read back through the port's PDG reader."""
    import tempfile
    from .io import pdg as pdg_io
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pdg.dat")
        mcids = write_decaying_pdg(path, n_species, seed)
        table = pdg_io.read_resonances_conventional(path)
    return table, mcids


def thermal_spectra(table, mcids, grid, dimension: int) -> np.ndarray:
    """(S, P, F, Y) smooth positive spectra exp(-MT / 0.16) (1 + 0.2 cos 2
    phi) exp(-y^2 / 8), float64, from a host grid."""
    mass = table.mass[[table.index_of_mcid(int(m)) for m in mcids]]
    pT = np.asarray(grid.pT, np.float64)
    phi = np.asarray(grid.phi, np.float64)
    y = np.asarray(grid.y, np.float64) if dimension == 3 else np.zeros(1)
    MT = np.sqrt(pT[None, :] ** 2 + mass[:, None] ** 2)
    return (np.exp(-MT / 0.16)[:, :, None, None]
            * (1.0 + 0.2 * np.cos(2.0 * phi))[None, None, :, None]
            * np.exp(-y ** 2 / 8.0)[None, None, None, :])


# The wave kernel's edges, shared by the gpu tests and chip_smoke.py: every
# 2- or 3-body task of the decaying list (24 species, all waves merged into
# one launch) on a ragged grid (7 pT up to 3 GeV x 9 phi x 5 y): parent MT
# past the slot's MT grid (the exp(c + s MT) tail), Phi in the wrap cell,
# massless daughters (omega -> pi0 gamma, eta' -> rho0 gamma), adjusted
# masses (f2 -> rho0 rho0, h1 -> f2 pi0), a row fed by many tasks (pi+),
# one parent row all zero (its log table the -745 floor) and one with its
# upper half in pT zero (patched by the tail fit); the narrow_y cases take
# 3 rapidities within |y| <= 0.05, so many (v, y) nodes have |Y| > y_max,
# and at small pT every v node of a 2-body task: its output is exactly 0.
# The stretched_y cases take 7 rapidities y_max sinh(2 u) / sinh(2), u
# uniform in [-1, 1]: on a y grid that is not uniform the Y stencils of
# neighbouring outputs are not always neighbours (the kernel's second
# stencil loop).
DECAY_EDGES = {
    **{f"{nb}body_{d}d": dict(nbody=nb, dimension=d)
       for nb in (2, 3) for d in (2, 3)},
    **{f"{nb}body_3d_narrow_y": dict(nbody=nb, dimension=3,
                                     grid=dict(n_y=3, y_max=0.05))
       for nb in (2, 3)},
    **{f"{nb}body_3d_stretched_y": dict(nbody=nb, dimension=3,
                                        grid=dict(n_y=7), stretch=2.0)
       for nb in (2, 3)},
}


# a backward launch whose float32 slot words do not fit in shared memory
# (18 x 26 x 65 words = 243 KB), so the backward kernel takes its device
# route by shape (decays.wave_bwd_blocking): the 3-body wave on a finer y
# grid, its first task (the plain version's autograd keeps ~10 GB);
# float32 only, as the forward kernel stages no float64 table of the grid
DECAY_ROUTE_EDGES = {
    "3body_3d_fine_y": dict(nbody=3, dimension=3, first_task=True,
                            grid=dict(n_pT=16, n_phi=24, n_y=65)),
}


def decay_edge_inputs(case: str, dtype=torch.float64, device="cpu"):
    """(tables, tasks, wg, n_seg): one launch of the wave kernel for the
    DECAY_EDGES (or DECAY_ROUTE_EDGES) case ``case``, on ``device``."""
    from .io.tables import native_momentum_grid
    from .kernels import decays
    spec = dict(dict(grid={}), **(DECAY_EDGES.get(case)
                                  or DECAY_ROUTE_EDGES[case]))
    dimension = spec["dimension"]
    table, mcids = synthetic_decaying_table(24)
    grid = native_momentum_grid(dimension, **dict(
        dict(n_pT=7, pT_max=3.0, n_phi=9, n_y=5, n_eta=4), **spec["grid"]))
    if "stretch" in spec:
        a = spec["stretch"]
        u = np.linspace(-1.0, 1.0, grid.y.shape[0])
        grid = dataclasses.replace(grid, y=torch.as_tensor(
            float(grid.y[-1]) * np.sinh(a * u) / np.sinh(a)))
    pT64 = grid.pT.numpy()
    waves = decays.plan_waves(decays._decay_schedule(table, mcids, pT64,
                                                     111))
    rows, masses, tasks = [], [], []
    for w in waves:
        pick = w.tasks2 if spec["nbody"] == 2 else w.tasks3
        tasks += [t[:2] + (t[2] + len(rows),) + t[3:] for t in pick]
        rows += w.rows
        masses += w.masses
    if spec.get("first_task"):
        tasks = tasks[:1]
    spectra = thermal_spectra(table, mcids, grid, dimension)
    spectra[rows[0]] = 0.0
    spectra[rows[-1], pT64.shape[0] // 2:] = 0.0
    wg = decays.wave_grid(grid, dimension, dtype, device)
    M = np.asarray(masses)
    mtg = torch.as_tensor(np.sqrt(pT64[None] ** 2 + M[:, None] ** 2),
                          dtype=dtype, device=device)
    acc = torch.as_tensor(spectra, device=device)
    tables = decays.parent_tables(
        acc, torch.as_tensor(rows, device=device),
        torch.as_tensor(M, device=device), mtg, dtype)
    return (tables, decays.wave_tasks(spec["nbody"], tasks, dtype, device),
            wg, len(mcids))


def decay_edge_seen(case: str, tables, tasks, wg, n_seg, out) -> str:
    """What the plain output of a DECAY_EDGES case shows of its edges;
    raises AssertionError where it does not show them."""
    from .kernels import decays
    assert torch.isfinite(out).all() and out.abs().max() > 0, case
    _, MT, Ph = decays.task_nodes(tasks, wg)
    mtg = tables.mtg[tasks.slot.long()]
    tail = int((MT > mtg[:, -1, None, None, None, None]).sum())
    Phi = torch.remainder(Ph[..., None] + wg.phi, decays.TWO_PI)
    wrap = int(((Phi < wg.phi[0]) | (Phi > wg.phi[-1])).sum())
    m2, counts = tasks.par[:, 1], torch.diff(tasks.tstart)
    massless = int((m2 == 0).sum())
    floor = int((tables.tc == -745.0).all(-1).all(-1).sum())
    assert tail and wrap and floor and counts.max() > 4, (
        tail, wrap, floor, counts.max())
    assert massless or tasks.nbody == 3, "no massless daughter"
    seen = (f"{tasks.slot.shape[0]} tasks, {tail} of {MT.numel()} nodes in "
            f"the tail, {wrap} Phi in the wrap cell, {massless} massless, a "
            f"row fed by {int(counts.max())}, {floor} slots at the floor")
    if case.endswith("stretched_y"):
        # runs of outputs whose Y stencils are not consecutive: the left
        # plane's offset from the output's index varies along the run
        Y = wg.y[:, None] + wg.quad[0] * decays.task_nodes(tasks, wg)[0][
            ..., None, None]                                # (K, S, P, Y, V)
        NY = wg.y.shape[0]
        L = torch.searchsorted(wg.y, Y.contiguous()).clamp(1, NY - 1) - 1
        off = L - torch.arange(NY, device=L.device)[:, None]
        inside = Y.abs() <= wg.y[-1].abs()
        big = 1 << 20
        spread = (torch.where(inside, off, -big).amax(-2)
                  - torch.where(inside, off, big).amin(-2))
        n = int(((spread > 0) & inside.any(-2)).sum())
        assert n > 0, "every run of stencils is consecutive"
        seen += f", {n} of {spread.numel()} (v) runs not consecutive"
    if case.endswith("narrow_y"):
        Y = wg.y[:, None] + wg.quad[0] * decays.task_nodes(tasks, wg)[0][
            ..., None, None]
        past = int((Y.abs() > wg.y[-1].abs()).sum())
        assert past > 0, "no (v, y) node past |y_max|"
        seen += f", {past} of {Y.numel()} (v, y) nodes past |y_max|"
        # a 3-body output keeps its s nodes near s+, where DeltaY -> 0
        if tasks.nbody == 2:
            fed = out[tasks.target.long()]
            n = int((fed == 0).sum())
            assert 0 < n < fed.numel(), f"{n} outputs are exactly 0"
            seen += f", {n} of {fed.numel()} fed outputs exactly 0"
    return seen


# ------------------------------------------------- the backward kernels' inputs

# The backward kernels' cotangents: positive weights (0.5 to 1.5) from a
# numpy seed, as a calibration loss weights its bins.  Signed random
# cotangents make the float32 gradient ill-conditioned at the regulator's
# kink: one evaluation whose |feqbar df| rounds to the other side of 1
# changes a sum of a few 1e4 terms that cancel down to its square root by
# one term (~3e-3 of the largest entry of a field on the 203-cell edge
# inputs; the plain version in float32 is off by 2e-4 there too), which
# positive weights keep at ~1e-5.
GRAD_SEED = 31


def grad_cotangent(shape, seed: int = GRAD_SEED, dtype=torch.float64,
                   device="cpu") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.5, 1.5, tuple(shape)), dtype=dtype,
                           device=device)


def spectra_grad_inputs(case: str, n_cells: int = 203, n_species: int = 7,
                        dtype=torch.float64, device="cpu"):
    """(cells, mom, flags, G): the backward spectra kernels' inputs for the
    SPECTRA_EDGES case ``case`` (spectra_edge_inputs) and a cotangent of
    the output's shape."""
    from .kernels import smooth
    cells, mom, flags = spectra_edge_inputs(case, n_cells, n_species, dtype,
                                            device)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    n_out = mom.nodes.shape[0] if flags.dimension == 3 else 1
    return cells, mom, flags, grad_cotangent((S, P, F, n_out), dtype=dtype,
                                             device=device)


def feqmod_grad_inputs(case: str, n_cells: int = 203, dtype=torch.float64,
                       device="cpu"):
    """(x, rn, wcs, mom, flags, G): the feqmod backward kernels' inputs for
    the FEQMOD_EDGES case ``case`` (feqmod_edge_inputs) and a cotangent of
    the output's shape."""
    x, rn, wcs, mom, flags, _, _ = feqmod_edge_inputs(case, n_cells,
                                                      dtype=dtype,
                                                      device=device)
    n_out = mom.nodes.shape[0] if flags.dimension == 3 else 1
    return x, rn, wcs, mom, flags, grad_cotangent(
        (mom.mass.shape[0], mom.pT.shape[0], mom.n_phi, n_out), dtype=dtype,
        device=device)


def vah_grad_inputs(case: str, n_cells: int = 203, dtype=torch.float64,
                    device="cpu"):
    """(x, mom, flags, G): the VAH backward kernels' inputs for the
    VAH_EDGES case ``case`` (vah_edge_inputs) and a cotangent of the
    output's shape."""
    x, mom, flags, _, _ = vah_edge_inputs(case, n_cells, dtype=dtype,
                                          device=device)
    n_out = mom.nodes.shape[0] if flags.dimension == 3 else 1
    return x, mom, flags, grad_cotangent(
        (mom.mass.shape[0], mom.pT.shape[0], mom.n_phi, n_out), dtype=dtype,
        device=device)


def polzn_grad_inputs(case: str, n_cells: int = 203, dtype=torch.float64,
                      device="cpu", **override):
    """(x, mom, pm, wR, flags, table, G): the polarization backward
    kernels' inputs for the POLZN_EDGES case ``case`` (polzn_edge_inputs,
    with ``override``) and a cotangent of the five sums (5, S, n_pT,
    n_phi, n_out)."""
    x, mom, pm, wR, flags, table = polzn_edge_inputs(
        case, n_cells=n_cells, dtype=dtype, device=device, **override)
    n_out = mom.nodes.shape[0] if flags.dimension == 3 else 1
    return x, mom, pm, wR, flags, table, grad_cotangent(
        (5, mom.mass.shape[0], mom.pT.shape[0], mom.n_phi, n_out),
        dtype=dtype, device=device)


def decay_grad_inputs(case: str, dtype=torch.float64, device="cpu"):
    """(tables, tasks, wg, G): the backward wave kernel's inputs for the
    DECAY_EDGES case ``case`` (decay_edge_inputs) and a float64 cotangent
    of the spectra it feeds."""
    tables, tasks, wg, n_seg = decay_edge_inputs(case, dtype, device)
    P, F, NY = tables.logdN.shape[1:]
    return tables, tasks, wg, grad_cotangent((n_seg, P, F, NY),
                                             device=device)


def wave_term_max(tables, tasks, wg, G) -> torch.Tensor:
    """(U, 2) float64: per slot the largest |g W exp(L) w_c| of the terms
    the backward wave kernel adds to its log rows (nodes inside the MT
    grid) and to its tail rows (nodes past it), over every task, s node,
    output, (v, zeta) node, Phi solution and corner (outputs with |Y| >
    |y_max| add none), from the plain version's gather form term by term
    in float64: what decays.wave_bwd_scale has to bound."""
    from .kernels import decays as d
    f64 = torch.float64
    t, wg = tables.to(None, f64), wg.to(None, f64)
    par, G = tasks.par.to(f64), G.to(f64)
    U, P, F, NY = t.logdN.shape
    x, wv, _ = wg.quad
    out = torch.zeros((U, 2), dtype=f64, device=G.device)
    for k in range(tasks.slot.shape[0]):
        u, seg = int(tasks.slot[k]), int(tasks.seg[k])
        p = par[k:k + 1, 1:]
        if tasks.nbody == 2:
            sets = [(p[:, 0], p[:, 1], p[:, 2], p[:, 3], 1.0)]
        else:
            Es, ps, sw = d._three_body_s(*p.unbind(1), wg)
            sets = [(p[:, 0], Es[:, i], ps[:, i], p[:, 1], sw[0, i])
                    for i in range(d.GAUSS_PTS)]
        g = (par[k, 0] * G[seg]).abs()                     # (P, F, Y)
        mtg = t.mtg[u]
        for m2, Estar, pstar, M, sw in sets:
            DY, MT, Ph, vw = d._kinematics(m2, Estar, pstar, M, wg)
            MT, Ph, DY, vw = MT[0], Ph[0], DY[0], vw[0]   # (P, V, Z), (P,)
            W = sw * vw[..., None] * wv * MT
            iR = torch.searchsorted(mtg, MT.contiguous()).clamp(1, P - 1)
            tM = (MT - mtg[iR - 1]) / (mtg[iR] - mtg[iR - 1])
            inside = MT <= mtg[-1]
            W0 = torch.where(inside, 1.0 - tM, torch.ones_like(tM))
            W1 = torch.where(inside, tM, MT)
            cM = torch.maximum(W0.abs(), W1.abs())
            if NY > 1:
                Y = wg.y[None, :, None] + x[None, None, :] * DY[:, None, None]
                iYR = torch.searchsorted(wg.y, Y.contiguous()).clamp(1, NY - 1)
                tY = (Y - wg.y[iYR - 1]) / (wg.y[iYR] - wg.y[iYR - 1])
                planes = [(iYR - 1, 1.0 - tY), (iYR, tY)]   # (P, Y, V)
                cY = torch.maximum(1.0 - tY, tY)
                keep = Y.abs() <= wg.y[-1].abs()
            else:
                zero = torch.zeros((P, 1, d.GAUSS_PTS), dtype=torch.int64,
                                   device=G.device)
                planes = [(zero, None)]
                cY = torch.ones(zero.shape, dtype=f64, device=G.device)
                keep = torch.ones(zero.shape, dtype=torch.bool,
                                  device=G.device)
            for sg in (1.0, -1.0):
                Phip = torch.remainder(sg * Ph[:, None] + wg.phi[None, :,
                                                                   None, None],
                                       d.TWO_PI)           # (P, F, V, Z)
                iL, iRp, wL, wR = d._interp_phi_indices(wg.phi, Phip)
                iM = iR[:, None, :, :]
                L = 0.0
                for iY, wY in planes:
                    yy = iY[:, None, :, :, None]           # (P, 1, Y, V, 1)
                    e = lambda tab, m, c: tab[u, m, c, yy] if m is not None \
                        else tab[u, c, yy]
                    a5 = lambda v: v[:, :, None]           # add the Y axis
                    bi = ((e(t.logdN, a5(iM - 1), a5(iL)) * a5(wL)
                           + e(t.logdN, a5(iM - 1), a5(iRp)) * a5(wR))
                          * a5(1.0 - tM[:, None])
                          + (e(t.logdN, a5(iM), a5(iL)) * a5(wL)
                             + e(t.logdN, a5(iM), a5(iRp)) * a5(wR))
                          * a5(tM[:, None]))
                    MT5 = a5(MT[:, None])
                    tail = ((e(t.tc, None, a5(iL)) + e(t.ts, None, a5(iL))
                             * MT5) * a5(wL)
                            + (e(t.tc, None, a5(iRp)) + e(t.ts, None,
                                                           a5(iRp)) * MT5)
                            * a5(wR))
                    plane = torch.where(a5(inside[:, None]), bi, tail)
                    L = plane if wY is None else L + plane * wY[:, None, :,
                                                               :, None]
                term = (g[:, :, :, None, None] * W[:, None, None] * torch.exp(L)
                        * a5(cM[:, None]) * a5(torch.maximum(wL, wR))
                        * cY[:, None, :, :, None])
                term = torch.where(keep[:, None, :, :, None], term, 0.0)
                tin = inside[:, None, None]
                out[u, 0] = torch.maximum(out[u, 0], torch.where(
                    tin, term, 0.0).max())
                out[u, 1] = torch.maximum(out[u, 1], torch.where(
                    tin, 0.0, term).max())
    return out


def grad_field_errors(got, want, rtol: float, atol_rel: float) -> tuple:
    """Per field of a gradient, (entries outside rtol |want| + atol_rel x
    max|want| of the field, largest error over the field's largest value),
    two (fields,) CPU tensors: ``got``/``want`` (rows, ...) tensors, whose
    fields are the entries of a row, or tuples of tensors (each its own
    field)."""
    if isinstance(want, torch.Tensor):
        got = got.double().cpu().reshape(got.shape[0], -1)
        want = want.double().cpu().reshape(want.shape[0], -1)
        scale = want.abs().amax(0, keepdim=True)
        err = (got - want).abs()
        bad = (err > rtol * want.abs() + atol_rel * scale).sum(0)
        return bad, (err / scale.clamp_min(1e-300)).amax(0)
    out = [grad_field_errors(g.reshape(-1, 1), w.reshape(-1, 1), rtol,
                             atol_rel) for g, w in zip(got, want)]
    return torch.cat([b for b, _ in out]), torch.cat([e for _, e in out])


def grad_errors(got, want, rtol: float, atol_rel: float) -> tuple:
    """grad_field_errors over all fields: (entries outside the bar, the
    largest error over its field's largest value)."""
    bad, worst = grad_field_errors(got, want, rtol, atol_rel)
    return int(bad.sum()), float(worst.max())


# ------------------------------------------------- the sampler's edge cases

# K7's edge cases (kernels/sample.py:event_batch_cuda against
# event_batch_plain): every df mode in 2+1D and 3+1D; shear and bulk x
# ``scales`` (df 3 breaks down on a share of the cells, "2d_df3_broken" on
# most); baryon diffusion in 2+1D and 3+1D.  Every case
# has a massless species (index 2) and a quarter of its cells with dsigma
# = 0 (zero yield), neither of which a slot may draw.
SAMPLE_EDGES = {
    "2d_df1": dict(dimension=2, df_mode=1),
    "3d_df1": dict(dimension=3, df_mode=1),
    "2d_df2": dict(dimension=2, df_mode=2),
    "3d_df2": dict(dimension=3, df_mode=2),
    "2d_df2_baryon": dict(dimension=2, df_mode=2, baryon=True),
    "3d_df2_baryon": dict(dimension=3, df_mode=2, baryon=True),
    "2d_df3_broken": dict(dimension=2, df_mode=3, scales=(0.3, 0.01)),
    "3d_df3": dict(dimension=3, df_mode=3, scales=(0.1, 0.01)),
    "2d_df4": dict(dimension=2, df_mode=4, scales=(0.1, 0.01)),
    "3d_df4": dict(dimension=3, df_mode=4, scales=(0.1, 0.01)),
    # anisotropic hydro (K7-VAH): mode 2 gated (no c0..c4, every real VAH
    # file), each chain alone, every chain on with and without the clip
    "2d_vah": dict(dimension=2, vah=2),
    "2d_vah_shear": dict(dimension=2, vah=2, chains=1),
    "3d_vah_bulk": dict(dimension=3, vah=3, chains=2),
    "3d_vah_chains": dict(dimension=3, vah=3, chains=3),
    "2d_vah_chains_noreg": dict(dimension=2, vah=2, chains=3, regulate=0),
    # the binary-search draws (K7-search, sampler_alias = 0)
    "2d_df1_search": dict(dimension=2, df_mode=1, search=True),
    "3d_df2_search": dict(dimension=3, df_mode=2, search=True),
    "2d_df3_search_broken": dict(dimension=2, df_mode=3, scales=(0.3, 0.01),
                                 search=True),
    "3d_df4_search": dict(dimension=3, df_mode=4, scales=(0.1, 0.01),
                          search=True),
    "2d_vah_search": dict(dimension=2, vah=2, chains=3, search=True),
}
SAMPLE_EDGE_SEED = 23


def sample_edge_inputs(case: str, dtype=torch.float64, device="cpu",
                       n_cells: int = 1024, n_species: int = 13) -> dict:
    """The inputs of one batch of K7 for SAMPLE_EDGES[case]: rows and
    layout (kernels/sample.py:pack_rows), the draw's tables (alias, or the
    search's cumulative sums), species, the per-event counts (a full
    event, a third, an empty one, one hadron), n_cap, the Config (VAH: the
    gated one), and the cell data (for edge_seen).  A quarter of the cells
    have dsigma = 0 (zero yield) and species 2 is massless."""
    from .config import Config
    from .io.surface import ThermoAverages
    from .kernels import sample
    spec = SAMPLE_EDGES[case]
    dim = spec["dimension"]
    kw = dict(operation=2, dimension=dim, df_mode=spec.get("df_mode", 2),
              include_shear_deltaf=1, include_bulk_deltaf=1, y_cut=3.0,
              sampler_alias=0 if spec.get("search") else 1,
              regulate_deltaf=spec.get("regulate", 1))
    if spec.get("vah"):
        cells = synthetic_vah_cells(n_cells, dim, seed=7)
        chains = spec.get("chains", 0)
        coef = synthetic_vah_coefficients(cells, seed=7)
        for i in range(5):
            if (chains & 1 and i >= 3) or (chains & 2 and i < 3):
                cells[f"c{i}"] = coef[f"c{i}"]
        kw.update(mode=spec["vah"])
    else:
        cells = synthetic_surface_cells(n_cells, dim, seed=7)
        s_pi, s_bulk = spec.get("scales", (1.0, 1.0))
        for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
            cells[k] = cells[k] * s_pi
        cells["bulkPi"] = cells["bulkPi"] * s_bulk
    for k in ("dat", "dax", "day", "dan"):
        cells[k][::4] = 0.0
    if spec.get("baryon"):
        rng = np.random.default_rng(8)
        cells.update(muB=rng.uniform(0.05, 0.3, n_cells),
                     nB=rng.uniform(0.01, 0.05, n_cells),
                     Vx=rng.normal(0, 0.01, n_cells),
                     Vy=rng.normal(0, 0.01, n_cells),
                     Vn=rng.normal(0, 0.002, n_cells))
        kw.update(include_baryon=1, include_baryondiff_deltaf=1)
    species = synthetic_species(n_species, dtype=dtype, device=device)
    species = dataclasses.replace(species, mass=species.mass.clone())
    species.mass[2] = 0.0
    surface = surface_from_arrays(dtype=dtype, device=device, **cells)
    cfg = sample.sampler_effective_cfg(surface, Config(**kw))
    if spec.get("vah"):
        assert sample._kernel_df(cfg) == 8 | spec.get("chains", 0), case
    plasma = ThermoAverages(0.152, 0.33, 0.057, 0.0, 0.0)
    cell = sample.build_cell_data(surface, species,
                                  synthetic_deltaf_data(dtype, device), cfg,
                                  plasma)
    lam = float(cell["dn_tot"].sum())
    tables = sample.build_draw_tables(cell.pop("dn_list"), cell["dn_tot"],
                                      cfg, lam)
    rows, layout = sample.pack_rows(cell, cfg)
    n_cap = sample._slot_capacity(lam)
    counts = torch.tensor([n_cap, n_cap // 3, 0, 1], dtype=torch.int32,
                          device=device)
    return dict(rows=rows, layout=layout, tables=tables, species=species,
                counts=counts, n_cap=n_cap, cfg=cfg, cell=cell,
                seed=SAMPLE_EDGE_SEED, ev0=5)


def sample_edge_seen(case: str, inp: dict, out: dict) -> str:
    """Check that the case exercised what it claims on the slots ``out``
    (either version's): no slot drew the massless species or a zero-yield
    cell, slots needed more than one rejection round, kept hadrons; df 3:
    slots of broken-down cells ("broken": most of them).  Returns a short
    description; raises AssertionError otherwise."""
    counts = inp["counts"].cpu()
    n_cap = inp["n_cap"]
    valid = torch.arange(n_cap)[None, :] < counts[:, None]
    sidx, cidx = out["sidx"].cpu()[valid], out["cidx"].cpu()[valid].long()
    dn_tot = inp["cell"]["dn_tot"].cpu()
    assert not (sidx == 2).any(), "a slot drew the massless species"
    assert (dn_tot[cidx] > 0).all(), "a slot drew a zero-yield cell"
    assert (dn_tot == 0).sum() >= len(dn_tot) // 4
    rounds = out["rounds"].cpu()[valid]
    kept = int(out["keep"].cpu().sum())
    assert int(rounds.max()) > 1 and kept > 0
    desc = (f"{int(valid.sum())} slots, {kept} kept, rounds up to "
            f"{int(rounds.max())}")
    cfg = inp["cfg"]
    chains = int(cfg.include_shear_deltaf) | int(cfg.include_bulk_deltaf) << 1
    if cfg.mode in (2, 3) and chains:
        desc += f", chains {chains}"
    if inp["cfg"].df_mode == 3 and inp["cfg"].mode not in (2, 3):
        broken = inp["cell"]["breakdown"].cpu()[cidx].double().mean().item()
        assert broken > (0.5 if "broken" in case else 0.0), broken
        desc += f", {broken:.0%} of slots on broken-down cells"
    return desc


# K7b (kernels/sample.py:species_yields): per case the df mode (or VAH),
# dimension-free; breakdown cells, a massless species, strong negative
# bulk (clamped densities), large roots in float32 (light species at low
# T: e^pbar would overflow), baryon chemistry
YIELDS_EDGES = {
    "df1": dict(df_mode=1),
    "df2_baryon": dict(df_mode=2, baryon=True),
    "df3_broken": dict(df_mode=3, broken=0.5),
    "df3_baryon": dict(df_mode=3, baryon=True, broken=0.2),
    "df3_negative": dict(df_mode=3, bulk=-40.0),
    "df4_broken": dict(df_mode=4, broken=0.3),
    "vah": dict(vah=True),
    "vah_cold": dict(vah=True, cold=True),
}


def yields_edge_inputs(case: str, dtype=torch.float64, device="cpu",
                       n_cells: int = 777, n_species: int = 41) -> dict:
    """K7b's inputs for YIELDS_EDGES[case]: the per-cell columns
    (kernels/sample.py:YIELDS_VH_COLS or YIELDS_VAH_COLS), species (2
    massless), the Gauss-Laguerre rules and the Config."""
    from .config import Config
    from .io.tables import laguerre_device
    spec = YIELDS_EDGES[case]
    rng = np.random.default_rng(41)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    species = synthetic_species(n_species, dtype=dtype, device=device)
    species = dataclasses.replace(species, mass=species.mass.clone())
    species.mass[2] = 0.0
    lag = laguerre_device(32, (1, 2), dtype=dtype, device=device)
    T = rng.uniform(0.02, 0.05, n_cells) if spec.get("cold") else \
        rng.uniform(0.12, 0.17, n_cells)
    if spec.get("vah"):
        cfg = Config(operation=2, mode=2)
        cols = dict(Lambda=t(T), aL=t(rng.uniform(0.3, 1.8, n_cells)))
    else:
        cfg = Config(operation=2, df_mode=spec["df_mode"],
                     include_baryon=int(bool(spec.get("baryon"))))
        broken = rng.random(n_cells) < spec.get("broken", 0.0)
        cols = dict(T=t(T), alphaB=t(rng.uniform(0.0, 2.0, n_cells)
                                     if spec.get("baryon") else
                                     np.zeros(n_cells)),
                    bulkPi=t(rng.normal(spec.get("bulk", 0.0), 0.02,
                                        n_cells)),
                    breakdown=torch.as_tensor(broken, device=device),
                    F=t(rng.normal(0.0, 0.1, n_cells)),
                    G=t(rng.normal(0.0, 0.1, n_cells)),
                    z=t(rng.uniform(0.5, 1.5, n_cells)),
                    betabulk=t(rng.uniform(0.05, 0.2, n_cells)))
    return dict(cols=cols, species=species, laguerre=lag, cfg=cfg)


def yields_edge_seen(case: str, inp: dict, dn: torch.Tensor) -> str:
    """Check that the case exercised what it claims on the densities
    ``dn`` (either version's): the massless species all zero, finite
    values; df3_negative: clamped zeros; broken cases: both branches.
    Returns a short description; raises AssertionError otherwise."""
    dn = dn.double().cpu()
    assert torch.isfinite(dn).all()
    assert (dn[:, 2] == 0).all(), "a massless species has a density"
    zeros = int((dn == 0).sum()) - dn.shape[0]
    desc = f"{tuple(dn.shape)}, {zeros} clamped zeros"
    if case == "df3_negative":
        assert zeros > 0, "no density was clamped"
    if "broken" in case:
        b = inp["cols"]["breakdown"].cpu()
        assert 0 < int(b.sum()) < b.numel()
        desc += f", {int(b.sum())} broken-down cells"
    return desc


def alias_edge_weights(dtype=torch.float64, device="cpu") -> dict:
    """Weight matrices for K7a (kernels/sample.py:alias_tables_cuda):
    zero rows, one nonzero entry, flat rows, a 1e12 dynamic range with
    60 % zeros, rows of few distinct values (ties the sort keeps in index
    order), the main path's shapes (rows of 320 species, blocks of 512
    cells, one row of 256 blocks), and rows of 9000 entries, too long for
    the kernel's shared memory (a group row of a 4.6M-cell surface)."""
    rng = np.random.default_rng(3)
    mixed = rng.lognormal(0.0, 4.0, (64, 37)) * (rng.random((64, 37)) > 0.6)
    mixed[0] = 0.0
    mixed[1] = 0.0
    mixed[1, 5] = 1e-3
    mixed[2] = 1.0
    mixed[3, :] = 1e-12
    mixed[3, 7] = 1.0
    cases = dict(mixed=mixed, k1=rng.random((5, 1)), k2=rng.random((9, 2)),
                 ties=rng.integers(0, 4, (40, 77)).astype(float),
                 species=rng.gamma(0.3, 1.0, (4096, 320)),
                 blocks=rng.gamma(2.0, 1.0, (256, 512)) * (rng.random(
                     (256, 512)) > 0.1),
                 groups=rng.gamma(5.0, 1.0, (1, 256)),
                 long=rng.gamma(0.5, 1.0, (2, 9000)))
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in cases.items()}


# channels a species in cascade_edge_inputs' wide tables, as real PDG
# lists have (the synthetic list has at most 4)
WIDE_CHANNELS = 64


def widen_decay_tables(tabs, channels: int):
    """The same decay tables padded with no-op channels (cum 1, two
    daughters of species 0) to ``channels`` a species: a species' last
    real channel already closes its row at 1 and no uniform reaches 1, so
    every cascade is the same."""
    pad = ((0, 0), (0, channels - tabs.cum.shape[1]))
    return dataclasses.replace(
        tabs, cum=np.pad(tabs.cum, pad, constant_values=1.0),
        nd=np.pad(tabs.nd, pad, constant_values=2),
        d1=np.pad(tabs.d1, pad), d2=np.pad(tabs.d2, pad),
        d3=np.pad(tabs.d3, pad), quant=np.pad(tabs.quant, pad + ((0, 0),)))


def cascade_edge_inputs(dtype=torch.float64, device="cpu", n: int = 3000,
                        n_species: int = 60, seed: int = 0,
                        channels: int | None = None) -> dict:
    """K8's inputs on the decaying synthetic list: ``n`` hadrons of every
    species (stable ones pass through a pass untouched) in events of 10,
    their cascade state (kernels/mc_decays.py:initial_state) at the
    worst-case capacity, the table, its device tables and the key;
    ``channels`` widens the tables (``widen_decay_tables``)."""
    from .kernels import mc_decays, rng as krng
    table, _ = synthetic_decaying_table(n_species, seed)
    tabs = mc_decays.build_decay_tables(table)
    if channels is not None:
        tabs = widen_decay_tables(tabs, channels)
    r = np.random.default_rng(seed + 1)
    sidx = r.integers(0, len(tabs.mc_id), n).astype(np.int32)
    m = tabs.mass[sidx]
    p = r.normal(0.0, 0.6, (n, 3))
    cols = dict(px=p[:, 0], py=p[:, 1], pz=p[:, 2],
                E=np.sqrt(m**2 + (p**2).sum(1)), t=r.uniform(4, 9, n),
                x=r.normal(0, 3, n), y=r.normal(0, 3, n),
                z=r.normal(0, 1, n))
    eid = (np.arange(n) // 10).astype(np.int32)
    cap = 1 << int(int(tabs.maxmult[sidx].sum()) - 1).bit_length()
    key = krng.seed_key(mc_decays.derive_decay_seed(seed))
    st = mc_decays.initial_state(sidx, cols, eid, eid.astype(np.int64) + 3,
                                 np.arange(n) % 10, cap, key, dtype, device)
    return dict(state=st, n0=n, table=table, tabs=tabs,
                dev_tabs=tabs.device(dtype, device), key=key)


# --------------------------------------------------- ranks of a CellMesh
# The multi-GPU tests and chip_smoke.py's [mesh] phases run a function on
# W spawned ranks joined by parallel.multihost.initialize over a file://
# rendezvous; the mesh cases below are what those ranks run.

def _rank_entry(target, rank: int, world_size: int, init: str, backend: str,
                device: str, threads, args: tuple, out: str):
    import traceback
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "gloo":
            # the ranks talk over the loopback interface
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        import torch.distributed as dist
        from .parallel import multihost
        multihost.initialize(init, world_size, rank, backend)
        try:
            result = target(multihost.global_mesh(dev), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(target, world_size: int, work_dir: str, args: tuple = (),
              backend: str = "gloo", device: str = "cpu",
              timeout: float = 300.0, threads: int | None = 1) -> list:
    """``target(mesh, *args)`` on ``world_size`` spawned ranks, each with
    the CellMesh of the group on ``device`` (every rank the same device:
    "cuda:0" makes the ranks share one card), joined by a file://
    rendezvous under ``work_dir``; returns each rank's return value in
    rank order.  ``target`` must be importable (a module-level function).
    A rank that fails ends the call with its traceback, and ranks still
    running after ``timeout`` seconds are killed and the call raises
    TimeoutError; no rank outlives the call."""
    import multiprocessing
    import time
    import uuid
    os.makedirs(work_dir, exist_ok=True)
    tag = uuid.uuid4().hex[:12]
    init = "file://" + os.path.join(os.path.abspath(work_dir), f"rdzv_{tag}")
    outs = [os.path.join(work_dir, f"rank{r}_{tag}.pt")
            for r in range(world_size)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, world_size, init, backend, device,
                               threads, args, outs[r]))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                errs = []
                for r in failed:
                    path = outs[r] + ".err"
                    text = (open(path).read() if os.path.exists(path)
                            else f"exit code {codes[r]}")
                    errs.append(f"rank {r}:\n{text}")
                raise RuntimeError(f"{len(failed)} of {world_size} ranks "
                                   "failed:\n" + "\n".join(errs))
            if time.monotonic() > deadline:
                alive = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"ranks {alive} of {world_size} still "
                                   f"running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(o, weights_only=False) for o in outs]


def mesh_case(case: dict, mesh=None, slice_local: bool = False):
    """One cell-reduced run of a mesh case -- a dict of ``kind`` (smooth:
    the df 1-4 spectra; vah; polzn; dndx), ``surface``, ``species``,
    ``grid``, ``df_data``, ``cfg`` and (polzn) ``plasma`` -- in one process
    (``mesh`` None), over the mesh's ranks with the full columns, or
    slice-local: each rank only the columns of its process_cell_slice."""
    from .kernels import smooth, feqmod, vah, polzn, dndx
    from .kernels.common import surface_columns
    from .parallel import mesh as pmesh, multihost as mh
    kind, s, cfg = case["kind"], case["surface"], case["cfg"]
    sp, grid, df = case["species"], case["grid"], case.get("df_data")
    feq = cfg.df_mode in (3, 4) and cfg.mode not in (2, 3)
    if not slice_local:
        if kind == "smooth" and mesh is not None:
            return pmesh.smooth_spectra_sharded(s, sp, grid, df, cfg,
                                                mesh=mesh)
        if kind == "smooth":
            return (feqmod.smooth_spectra_feqmod(s, sp, grid, df, cfg) if feq
                    else smooth.smooth_spectra(s, sp, grid, df, cfg))
        if kind == "vah":
            return vah.smooth_spectra_vah(s, sp, grid, cfg, mesh=mesh)
        if kind == "polzn":
            return polzn.spin_polarization(s, sp, grid, cfg, case["plasma"],
                                           mesh=mesh)
        return dndx.spacetime_distributions(s, sp, grid, df, cfg, mesh=mesh)
    n = s.tau.shape[0]
    a, b = mh.process_cell_slice(cfg, n, mesh)

    def cut(cols):
        return {k: v[a:b] for k, v in cols.items()}
    if kind == "smooth":
        cols = cut(surface_columns(s, cfg))
        if feq:
            return mh.feqmod_spectra_multihost(cols, n, sp, grid, df, cfg,
                                               mesh=mesh)
        return mh.smooth_spectra_multihost(cols, n, sp, grid, df, cfg, mesh)
    if kind == "vah":
        return mh.smooth_spectra_vah_multihost(cut(vah.vah_surface_cols(s)),
                                               n, sp, grid, cfg, mesh)
    if kind == "polzn":
        return mh.spin_polarization_multihost(cut(polzn.polzn_cols(s)), n,
                                              sp, grid, cfg, case["plasma"],
                                              mesh)
    cols = cut(dndx.dndx_cols(s, cfg))
    if feq:
        return mh.feqmod_spacetime_distributions_multihost(
            cols, n, sp, grid, df, cfg, mesh=mesh)
    return mh.spacetime_distributions_multihost(cols, n, sp, grid, df, cfg,
                                                mesh)


def mesh_cases_rank(mesh, inputs_path: str, names) -> dict:
    """A rank's results of the mesh cases ``names`` of the torch.save'd
    dict at ``inputs_path``: with the full columns and slice-local, each
    with the real groups the rank launched."""
    from .parallel.mesh import MESH_STATS, reset_mesh_stats
    cases = torch.load(inputs_path, weights_only=False)
    out = {}
    for name in names:
        reset_mesh_stats()
        full = mesh_case(cases[name], mesh)
        groups = MESH_STATS["groups"]
        reset_mesh_stats()
        local = mesh_case(cases[name], mesh, slice_local=True)
        out[name] = dict(mesh=full, groups=groups, slice=local,
                         slice_groups=MESH_STATS["groups"])
        if cases[name]["cfg"].mode in (2, 3):
            out[name]["gates"] = _vah_gates(cases[name], mesh)
    return out


def _vah_gates(case: dict, mesh) -> dict:
    """The VAH gate's (shear, bulk) chains of a mesh case: of the full
    columns, agreed over the ranks from their slices, and of the rank's
    slice alone."""
    from .kernels import vah
    from .parallel.multihost import process_cell_slice
    cfg = case["cfg"]
    cols = vah.vah_surface_cols(case["surface"])
    a, b = process_cell_slice(cfg, cols["tau"].shape[0], mesh)
    local = {k: v[a:b] for k, v in cols.items()}
    chains = lambda c: (c.include_shear_deltaf, c.include_bulk_deltaf)
    return dict(full=chains(vah.effective_vah_cfg(cols, cfg)),
                agreed=chains(vah.agreed_vah_cfg(local, cfg, mesh)),
                local=chains(vah.effective_vah_cfg(local, cfg)))


def mesh_suite_rank(mesh, inputs_path: str, names, runs, grads) -> dict:
    """One spawn's work of a rank: mesh_cases_rank of ``names``,
    mesh_api_rank of ``runs`` and mesh_grad_rank of each (name, wrt) of
    ``grads``."""
    return dict(cases=mesh_cases_rank(mesh, inputs_path, names),
                api=mesh_api_rank(mesh, runs),
                grads={name: mesh_grad_rank(mesh, inputs_path, name, wrt)
                       for name, wrt in grads})


def mesh_grad_loss(case: dict, out):
    """The scalar loss of the mesh gradient cases: the Lambda row's
    polarization sums (polzn), else sum dN/dy + sum <pT>."""
    if case["kind"] == "polzn":
        return out["Sy_over_Snorm"].sum() + out["Snorm"].sum()
    from .diff import dN_dy_j, mean_pT_j
    return (dN_dy_j(out, case["grid"]).sum()
            + mean_pT_j(out, case["grid"]).sum())


def mesh_grad(case: dict, wrt, mesh=None) -> dict:
    """The gradient of mesh_grad_loss by the surface fields ``wrt``
    (diff.surface_value_and_grad), the loss's cotangent on the map's
    output, and diff.surface_vjp's pullback of that cotangent, in one
    process (``mesh`` None) or over the mesh."""
    from . import diff
    if case["kind"] == "polzn":
        fn = diff.polarization_fn(case["species"], case["grid"], case["cfg"],
                                  case["plasma"], mesh=mesh)
    else:
        fn = diff.spectra_fn(case["species"], case["grid"],
                             case.get("df_data"), case["cfg"], mesh=mesh)
    value, grads = diff.surface_value_and_grad(
        lambda x: mesh_grad_loss(case, fn(x)), case["surface"], wrt)
    out, pullback = diff.surface_vjp(fn, case["surface"], wrt)
    with torch.enable_grad():
        if isinstance(out, dict):
            y = {k: v.clone().requires_grad_(True) for k, v in out.items()}
            cts = torch.autograd.grad(mesh_grad_loss(case, y), list(y.values()),
                                      allow_unused=True)
            ct = {k: torch.zeros_like(v) if c is None else c
                  for (k, v), c in zip(y.items(), cts)}
        else:
            y = out.clone().requires_grad_(True)
            ct = torch.autograd.grad(mesh_grad_loss(case, y), y)[0]
    return dict(value=value, grads=grads, cotangent=ct, vjp=pullback(ct))


def mesh_grad_rank(mesh, inputs_path: str, name: str, wrt) -> dict:
    """A rank's mesh_grad of the case ``name`` of the torch.save'd dict at
    ``inputs_path``."""
    return mesh_grad(torch.load(inputs_path, weights_only=False)[name], wrt,
                     mesh)


def mesh_api_rank(mesh, runs, write: bool = True) -> dict:
    """A rank's api.IS3D(mesh=) runs: each of ``runs`` a dict of name,
    run_dir, overrides and results_dir (with ``write`` rank 0 writes
    there; another rank is given ``<results_dir>_rank<r>``, where it must
    write nothing, unless the run is ``shared``: operation 2 over ranks
    merges part files in the one results_dir).  Returns each run's
    spectra, dN/dX, polarization, events, the real groups the rank
    launched, its parallel.mesh.MESH_STATS, wall seconds and whether its
    results directory exists."""
    import time
    from .api import IS3D
    from .parallel.mesh import MESH_STATS, reset_mesh_stats
    out = {}
    for run in runs:
        results = run["results_dir"] + (
            "" if mesh.rank == 0 or run.get("shared")
            else f"_rank{mesh.rank}")
        reset_mesh_stats()
        t0 = time.perf_counter()
        res = IS3D.from_run_dir(run["run_dir"], overrides=run["overrides"],
                                results_dir=results, mesh=mesh
                                ).run_particlization(write_files=write)
        out[run["name"]] = dict(spectra=res.spectra, dN_dX=res.dN_dX,
                                polarization=res.polarization,
                                events=res.events,
                                groups=MESH_STATS["groups"],
                                stats=dict(MESH_STATS),
                                wall=time.perf_counter() - t0,
                                wrote=os.path.exists(results))
    return out


# ------------------------------------------- the event axis and pod mode
# What the ranks of tests/test_torch_parallel_events.py, test_torch_pod.py
# and chip_smoke.py's [mesh events], [mesh sample] and [pod] run: each
# helper runs in one process (``mesh`` None) or over the mesh's ranks.

def batched_case(case: dict, mesh=None):
    """An ensemble map of a batched case -- a dict of ``kind`` (spectra or
    polzn), ``stacked``, ``species``, ``grid``, ``df_data``, ``cfg`` and
    (polzn) ``T_avg`` -- over the event axis."""
    from . import batch
    if case["kind"] == "polzn":
        return batch.polarization_batched(case["stacked"], case["species"],
                                          case["grid"], case["cfg"],
                                          case["T_avg"], mesh=mesh)
    return batch.smooth_spectra_batched(case["stacked"], case["species"],
                                        case["grid"], case.get("df_data"),
                                        case["cfg"], mesh=mesh)


def batched_grad(case: dict, wrt, mesh=None) -> dict:
    """The gradient of sum dN/dy + sum <pT> over a batched spectra case's
    events by the stacked fields ``wrt`` (diff.surface_value_and_grad),
    and diff.surface_vjp's pullback of that loss's cotangent."""
    from . import diff

    def fn(stacked):
        return batched_case(dict(case, stacked=stacked), mesh)

    def loss(out):
        return sum(diff.dN_dy_j(row, case["grid"]).sum()
                   + diff.mean_pT_j(row, case["grid"]).sum() for row in out)
    value, grads = diff.surface_value_and_grad(lambda s: loss(fn(s)),
                                               case["stacked"], wrt)
    out, pullback = diff.surface_vjp(fn, case["stacked"], wrt)
    with torch.enable_grad():
        y = out.clone().requires_grad_(True)
        ct = torch.autograd.grad(loss(y), y)[0]
    return dict(value=value, grads=grads, vjp=pullback(ct))


def ensemble_run(run: dict, mesh=None, device="cpu") -> dict:
    """IS3D.run_ensemble of ``run`` (run_dir, overrides, surfaces: paths
    and/or Surfaces, results_dir); over a mesh, a rank other than 0 is
    given ``<results_dir>_rank<r>``, where it must write nothing.  Returns
    the events' spectra and polarization and whether the rank's results
    directory exists."""
    from .api import IS3D
    results = run["results_dir"] + ("" if mesh is None or mesh.rank == 0
                                    else f"_rank{mesh.rank}")
    out = IS3D.from_run_dir(run["run_dir"], overrides=run["overrides"],
                            results_dir=results, mesh=mesh,
                            device=None if mesh is not None else device
                            ).run_ensemble(run["surfaces"])
    pol = [r.polarization for r in out]
    return dict(spectra=np.stack([r.spectra for r in out]),
                polarization=None if pol[0] is None else
                {k: np.stack([p[k] for p in pol]) for k in pol[0]},
                wrote=os.path.exists(results))


def sample_case(case: dict, mesh=None, chunk=None) -> tuple:
    """sample_particles of a sampler case -- a dict of ``surface``,
    ``species``, ``mcids``, ``df_data``, ``cfg``, ``plasma``, ``nevents``
    and ``seed`` -- over the mesh's ranks (the cell-sharded sampler), or
    in one process as kernels.sample._sample_cell_chunked with ``chunk``
    cells a chunk; returns (events, info)."""
    from .kernels import sample
    info = {}
    args = (case["surface"], case["species"], case["mcids"],
            case.get("df_data"), case["cfg"], case["plasma"])
    if mesh is not None:
        ev = sample.sample_particles(*args, nevents=case["nevents"],
                                     seed=case["seed"], mesh=mesh, info=info)
        return ev, info
    cfg = sample.sampler_effective_cfg(case["surface"], case["cfg"])
    plan = sample._ChunkPlan(case["surface"], case["species"],
                             case.get("df_data"), cfg, case["plasma"], None,
                             chunk)
    return sample._sample_cell_chunked(plan, case["mcids"],
                                       nevents=case["nevents"],
                                       seed=case["seed"], info=info), info


def same_events(a: list, b: list) -> bool:
    """Two event lists equal field by field in dtype and bytes."""
    return len(a) == len(b) and all(
        sorted(x) == sorted(y) and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
            for k in x) for x, y in zip(a, b))


def event_suite_rank(mesh, inputs_path: str, ensembles, oversample,
                     grads) -> dict:
    """One spawn's work of a rank on the event axis and the cell-sharded
    sampler: every batched case of the torch.save'd inputs, the gradients
    of the batched cases named in ``grads`` ((name, wrt) pairs), each
    ensemble run of ``ensembles`` (ensemble_run), every sampler case, and
    ensemble.oversample_run(mesh=) of ``oversample``: the inputs' sampler
    case named by its ``case``, that case's cfg with its ``overrides``,
    and the rest of its keys as oversample_run's arguments.  The batched
    cases' walls are host-clock seconds."""
    import time
    from .ensemble import oversample_run
    inputs = torch.load(inputs_path, weights_only=False)
    out = dict(batched={}, grads={}, ensembles={}, samples={}, walls={})
    for name, case in inputs["batched"].items():
        t0 = time.perf_counter()
        out["batched"][name] = batched_case(case, mesh)
        out["walls"][name] = time.perf_counter() - t0
    for name, wrt in grads:
        out["grads"][name] = batched_grad(inputs["batched"][name], wrt, mesh)
    for run in ensembles:
        out["ensembles"][run["name"]] = ensemble_run(run, mesh)
    for name, case in inputs["samples"].items():
        out["samples"][name] = sample_case(case, mesh)
    if oversample is not None:
        kw = dict(oversample)
        c = inputs["samples"][kw.pop("case")]
        cfg = c["cfg"].replace(**kw.pop("overrides"))
        out["oversample"] = oversample_run(
            c["surface"], c["species"], c["mcids"], c.get("df_data"), cfg,
            c["plasma"], mesh=mesh, **kw)
    return out


def pod_entries(run_dir: str, overrides: dict, mesh) -> dict:
    """The pod entries of parallel.multihost on a run directory's prepared
    inputs (every rank holds the whole surface): the spectra of its
    surface mode and df mode (smooth_spectra_pod or
    smooth_spectra_vah_pod), mode 5's spin_polarization_pod and, with
    operation 0, spacetime_distributions_pod."""
    from .api import IS3D
    from .parallel import multihost as mh
    run = IS3D.from_run_dir(run_dir, overrides=overrides, mesh=mesh)
    run.read_fo_surf_from_file(write_averages=False)
    _, df_data, species, _, grid = run._prepare()
    cfg, s = run.cfg, run.surface
    out = {}
    if cfg.mode == 5:
        out["polarization"] = {k: v.cpu().numpy() for k, v in
                               mh.spin_polarization_pod(
                                   s, species, grid, cfg, run.plasma(),
                                   mesh).items()}
    if cfg.operation == 0:
        out["dN_dX"] = mh.spacetime_distributions_pod(s, species, grid,
                                                      df_data, cfg, mesh)
    elif cfg.mode in (2, 3):
        out["spectra"] = mh.smooth_spectra_vah_pod(
            s, species, grid, cfg, mesh).cpu().numpy()
    else:
        out["spectra"] = mh.smooth_spectra_pod(
            s, species, grid, df_data, cfg, mesh).cpu().numpy()
    return out


def pod_suite_rank(mesh, runs, entries, probe) -> dict:
    """One spawn's work of a rank in pod mode: mesh_api_rank of ``runs``
    (operation 2 over the ranks writes through rank 0's merge), the pod
    entries (pod_entries) of each run of ``entries``, multihost.pod_active()
    in the rank, and with ``probe``
    (a run whose results_dir each rank gets a copy of its own) the error
    the shared-filesystem probe raises."""
    from .parallel.multihost import pod_active
    out = dict(api=mesh_api_rank(mesh, runs),
               entries={e["name"]: pod_entries(e["run_dir"],
                                               e["overrides"], mesh)
                        for e in entries}, probe=None,
               pod_active=pod_active())
    if probe is not None:
        from .api import IS3D
        try:
            IS3D.from_run_dir(probe["run_dir"], overrides=probe["overrides"],
                              results_dir=f"{probe['results_dir']}_"
                                          f"{mesh.rank}",
                              mesh=mesh).run_particlization()
        except RuntimeError as err:
            out["probe"] = str(err)
    return out
