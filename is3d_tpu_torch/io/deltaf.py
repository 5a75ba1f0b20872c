"""Delta-f coefficient tables, splines, and per-species densities.

Reimplements the reference's Deltaf_Data (reference: src/cpp/deltafReader.cpp):

* loads the 10 coefficient tables c0..c4 (14-moment) and F, G, betabulk,
  betaV, betapi (Chapman-Enskog) on a uniform (T, muB) grid with
  temperature-power scalings baked into the files,
* builds natural cubic splines in T at muB = 0 (GSL cspline equivalent,
  deltafReader.cpp:300-322) and the Jonah z(bulkPi/Peq), lambda^2(bulkPi/Peq)
  splines from HRG kinetic-theory sums (deltafReader.cpp:222-297),
* evaluates coefficients per cell in torch on the cells' device: cubic
  spline at muB = 0 or bilinear in (T, muB) otherwise
  (deltafReader.cpp:325-504), indexing the value grid as [muB, T],
* computes per-species equilibrium/bulk/diffusion densities at the surface-
  averaged thermodynamic state (deltafReader.cpp:536-650).

Table loading and the Jonah and density quadratures run in numpy on the
host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..tensors import TensorContainer
from ..units import TWO_PI2_HBARC3
from ..physics.splines import CubicSpline, build_natural_cubic
from ..physics import thermal
from .tables import gauss_laguerre

_COEFF_NAMES = ("c0", "c1", "c2", "c3", "c4", "F", "G", "betabulk", "betaV", "betapi")
SPLINE_NAMES = ("c0", "c2", "c3", "F", "betabulk", "betaV", "betapi")

# Jonah lambda grid (reference: deltafReader.h:72-75)
JONAH_POINTS = 301
LAMBDA_MIN = -1.0
LAMBDA_MAX = 2.0


@dataclass(frozen=True)
class DeltafCoefficients(TensorContainer):
    """Per-cell coefficient bundle; unused entries are zero
    (mirrors deltaf_coefficients, readindata.h:105-131)."""

    c0: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor
    c4: torch.Tensor
    shear14: torch.Tensor
    F: torch.Tensor
    G: torch.Tensor
    betabulk: torch.Tensor
    betaV: torch.Tensor
    betapi: torch.Tensor
    lam: torch.Tensor
    z: torch.Tensor
    delta_lambda: torch.Tensor
    delta_z: torch.Tensor


@dataclass(frozen=True)
class DeltafData(TensorContainer):
    """Coefficient data.  Splines cover muB = 0; the raw (muB, T) grids
    support the bilinear nonzero-muB path."""

    T_grid: torch.Tensor             # (nT,)
    muB_grid: torch.Tensor           # (nmuB,)
    tables: dict                     # name -> (nmuB, nT) raw (T-scaled) values
    splines: dict                    # name -> CubicSpline at muB = 0 (raw values)
    lambda2_spline: Optional[CubicSpline]
    z_spline: Optional[CubicSpline]
    bulkPi_over_Peq_max: torch.Tensor  # scalar


def _load_coeff_file(path: str):
    with open(path) as f:
        lines = f.read().splitlines()
    nT = int(lines[0].split()[0])
    nmuB = int(lines[1].split()[0])
    # lines[2] is the header
    data = np.array(" ".join(lines[3:]).split(), dtype=np.float64).reshape(-1, 3)
    if data.shape[0] != nT * nmuB:
        raise ValueError(f"{path}: expected {nT * nmuB} rows, got {data.shape[0]}")
    T = data[:nT, 0]
    muB = data[::nT, 1]
    vals = data[:, 2].reshape(nmuB, nT)
    return T, muB, vals


def load_deltaf_tables(coeff_dir: str, hrg_eos: int):
    """Load all ten tables from deltaf_coefficients/vh/{urqmd,smash,smash_box}
    (reference: deltafReader.cpp:65-219, paths deltafReader.h:27-29)."""
    sub = {1: "urqmd", 2: "smash", 3: "smash_box"}[hrg_eos]
    tables = {}
    T = muB = None
    for name in _COEFF_NAMES:
        T, muB, vals = _load_coeff_file(f"{coeff_dir}/vh/{sub}/{name}.dat")
        tables[name] = vals
    return T, muB, tables


def compute_jonah_arrays(mass, gspin, sign, T_avg: float, laguerre=None):
    """Tabulate z(bulkPi/Peq) and lambda^2(bulkPi/Peq) from HRG kinetic theory
    (reference: deltafReader.cpp:222-289).  Host-side numpy; species with
    zero mass (photon) are skipped."""
    if laguerre is None:
        laguerre = gauss_laguerre(32, alphas=(1, 2, 3))
    r2, w2 = laguerre[2]

    mass = np.asarray(mass, dtype=np.float64)
    gspin = np.asarray(gspin, dtype=np.float64)
    sign = np.asarray(sign, dtype=np.float64)
    keep = mass > 0.0
    mbar = mass[keep] / T_avg                       # (S,)
    deg = gspin[keep]
    sgn = sign[keep]

    lambdas = np.linspace(LAMBDA_MIN, LAMBDA_MAX, JONAH_POINTS)

    # quadrature over pbar for all (lambda, species) at once: the thermal
    # weight w2 * deg * e^pbar f_eq and the P_mod identity
    # pbar^2 scale2 / E_mod = E_mod - mb^2 / E_mod keep this to a few
    # full-rank passes
    ebar = np.sqrt(r2[None, :] ** 2 + mbar[:, None] ** 2)        # (S,Q)
    common = (w2[None, :] * deg[:, None] * np.exp(r2)[None, :]
              / (np.exp(ebar) + sgn[:, None]))                   # (S,Q)
    common_m = common * (mbar ** 2)[:, None]
    scale2 = (1.0 + lambdas[:, None, None]) ** 2                 # (L,1,1)
    x2 = scale2 * (r2 ** 2)[None, None, :] + (mbar ** 2)[None, :, None]
    emod = np.sqrt(x2)                                           # (L,S,Q)
    E_mod = np.einsum("lsq,sq->l", emod, common)
    P_mod = (E_mod - np.einsum("lsq,sq->l", 1.0 / emod, common_m)) / 3.0
    # equilibrium E, P: the scale2 = 1 (lambda = 0) evaluation, done exactly
    E_eq = float((ebar * common).sum())
    P_eq = float((E_eq - (common_m / ebar).sum()) / 3.0)

    z = E_eq / E_mod
    bulkPi_over_Peq = (P_mod / P_eq) * z - 1.0
    if not np.all(np.diff(bulkPi_over_Peq) > 0):
        raise ValueError("Jonah bulkPi/Peq grid is not monotonic")
    return bulkPi_over_Peq, lambdas**2, z


def build_deltaf_data(coeff_dir: str, hrg_eos: int,
                      particle_table=None, T_avg: Optional[float] = None,
                      include_jonah: bool = True, dtype=torch.float64,
                      device="cpu") -> DeltafData:
    T, muB, raw = load_deltaf_tables(coeff_dir, hrg_eos)
    splines = {name: build_natural_cubic(T, raw[name][0], dtype, device)
               for name in SPLINE_NAMES}

    lambda2_spline = z_spline = None
    bulk_max = -1.0
    if include_jonah:
        if particle_table is None or T_avg is None:
            raise ValueError("Jonah splines need particle_table and T_avg")
        x, lam2, z = compute_jonah_arrays(particle_table.mass,
                                          particle_table.gspin,
                                          particle_table.sign, T_avg)
        lambda2_spline = build_natural_cubic(x, lam2, dtype, device)
        z_spline = build_natural_cubic(x, z, dtype, device)
        bulk_max = float(x.max())

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return DeltafData(
        T_grid=t(T), muB_grid=t(muB),
        tables={k: t(v) for k, v in raw.items()},
        splines=splines,
        lambda2_spline=lambda2_spline,
        z_spline=z_spline,
        bulkPi_over_Peq_max=t(bulk_max),
    )


# ------------------------------------------------------------- evaluation

def validate_df_range(data: DeltafData, T: np.ndarray, muB: np.ndarray) -> None:
    """Host-side range check for the nonzero-muB bilinear path: the
    reference aborts on (T, muB) outside the coefficient table
    (deltafReader.cpp:425-429), while _bilinear can only clamp indices and
    silently extrapolate.  Raises with the offending range."""
    T_lo, T_hi = float(data.T_grid[0]), float(data.T_grid[-1])
    B_lo, B_hi = float(data.muB_grid[0]), float(data.muB_grid[-1])
    bad_T = (T < T_lo) | (T > T_hi)
    bad_B = (muB < B_lo) | (muB > B_hi)
    if bad_T.any() or bad_B.any():
        raise ValueError(
            f"surface (T, muB) outside the df coefficient table: "
            f"T in [{float(T.min()):.4f}, {float(T.max()):.4f}] vs table "
            f"[{T_lo:.4f}, {T_hi:.4f}] GeV ({int(bad_T.sum())} cells out); "
            f"muB in [{float(muB.min()):.4f}, {float(muB.max()):.4f}] vs "
            f"[{B_lo:.4f}, {B_hi:.4f}] GeV ({int(bad_B.sum())} cells out) "
            f"-- the reference exits here too (deltafReader.cpp:425-429)")


def _bilinear(grid_vals, T_grid, muB_grid, T, muB):
    """Uniform-grid bilinear interpolation of a (nmuB, nT) table."""
    dT = T_grid[1] - T_grid[0]
    dmuB = muB_grid[1] - muB_grid[0]
    iT = torch.clamp(torch.floor((T - T_grid[0]) / dT).long(), 0,
                     T_grid.shape[0] - 2)
    iB = torch.clamp(torch.floor((muB - muB_grid[0]) / dmuB).long(), 0,
                     muB_grid.shape[0] - 2)
    tT = (T - T_grid[iT]) / dT
    tB = (muB - muB_grid[iB]) / dmuB
    f00 = grid_vals[iB, iT]
    f01 = grid_vals[iB, iT + 1]
    f10 = grid_vals[iB + 1, iT]
    f11 = grid_vals[iB + 1, iT + 1]
    return ((1 - tB) * ((1 - tT) * f00 + tT * f01)
            + tB * ((1 - tT) * f10 + tT * f11))


def evaluate_df_coefficients(data: DeltafData, df_mode: int, include_baryon: bool,
                             T, muB, E, P, bulkPi) -> DeltafCoefficients:
    """Per-cell coefficient evaluation on the tensors' device.

    Undoes the temperature-power scaling of the tabulated values exactly as
    the reference (deltafReader.cpp:325-484).
    """
    z0 = torch.zeros_like(T)
    out = dict(c0=z0, c1=z0, c2=z0, c3=z0, c4=z0, shear14=z0, F=z0, G=z0,
               betabulk=z0, betaV=torch.ones_like(T), betapi=z0,
               lam=z0, z=z0, delta_lambda=z0, delta_z=z0)

    T4 = T**4

    if not include_baryon:
        ev = lambda name: data.splines[name](T)
        if df_mode == 1:
            out["c0"] = ev("c0") / T4
            out["c2"] = ev("c2") / T4
            out["shear14"] = 2.0 * T * T * (E + P)
        elif df_mode in (2, 3):
            out["F"] = ev("F") * T
            out["betabulk"] = ev("betabulk") * T4
            # betaV = 1.0 is the REFERENCE's own muB=0 placeholder
            # (deltafReader.cpp:358): baryon diffusion is inert at muB=0
            out["betaV"] = torch.ones_like(T)
            out["betapi"] = ev("betapi") * T4
        elif df_mode == 4:
            x = bulkPi / P
            lam2 = data.lambda2_spline(x)
            out["lam"] = torch.sign(bulkPi) * torch.sqrt(torch.clamp(lam2, min=0.0))
            out["z"] = data.z_spline(x)
            betapi = ev("betapi") * T4
            out["betapi"] = betapi
            dl = bulkPi / (5.0 * betapi - 3.0 * P * (E + P) / E)
            out["delta_lambda"] = dl
            out["delta_z"] = -3.0 * dl * P / E
        else:
            raise ValueError(f"df_mode must be 1-4, got {df_mode}")
    else:
        bil = lambda name: _bilinear(data.tables[name], data.T_grid,
                                     data.muB_grid, T, muB)
        if df_mode == 1:
            T3, T5 = T**3, T**5
            out["c0"] = bil("c0") / T4
            out["c1"] = bil("c1") / T3
            out["c2"] = bil("c2") / T4
            out["c3"] = bil("c3") / T4
            out["c4"] = bil("c4") / T5
            out["shear14"] = 2.0 * T * T * (E + P)
        elif df_mode in (2, 3):
            T3 = T**3
            out["F"] = bil("F") * T
            out["G"] = bil("G")
            out["betabulk"] = bil("betabulk") * T4
            out["betaV"] = bil("betaV") * T3
            out["betapi"] = bil("betapi") * T4
        elif df_mode == 4:
            raise ValueError("Jonah df (mode 4) requires muB = 0 "
                             "(include_baryon = 0)")
        else:
            raise ValueError(f"df_mode must be 1-4, got {df_mode}")

    return DeltafCoefficients(**out)


# ----------------------------------------------------- species densities

def compute_particle_densities(particle_table, df_mode: int, avg,
                               deltaf_data: DeltafData, include_baryon: bool,
                               laguerre=None):
    """Fill equilibrium/bulk/diffusion densities per species at the surface-
    averaged state (reference: deltafReader.cpp:536-650).  Mutates and returns
    the particle table (numpy, host-side); the coefficients are evaluated
    in float64 on the host from ``deltaf_data``."""
    if laguerre is None:
        laguerre = gauss_laguerre(32, alphas=(1, 2, 3))
    r1, w1 = laguerre[1]
    r2, w2 = laguerre[2]
    r3, w3 = laguerre[3]

    T = avg.temperature
    E = avg.energy_density
    P = avg.pressure
    muB = avg.baryon_chemical_potential
    nB = avg.net_baryon_density
    alphaB = muB / T if T > 0 else 0.0
    benth = nB / (E + P)

    host = deltaf_data.to("cpu", torch.float64)
    scalar = lambda v: torch.tensor(v, dtype=torch.float64)
    df = evaluate_df_coefficients(host, df_mode, include_baryon,
                                  scalar(T), scalar(muB), scalar(E),
                                  scalar(P), scalar(0.0))
    df = {k: float(getattr(df, k)) for k in
          ("c0", "c1", "c2", "c3", "c4", "F", "G", "betabulk", "betaV")}

    mass = np.asarray(particle_table.mass)
    deg = np.asarray(particle_table.gspin, dtype=np.float64)
    baryon = np.asarray(particle_table.baryon, dtype=np.float64)
    sign = np.asarray(particle_table.sign, dtype=np.float64)
    mbar = mass / T

    gt = lambda integrand, r, w: thermal.gauss_thermal(
        integrand, r, w, mbar, alphaB, baryon, sign)

    neq_fact = deg * T**3 / TWO_PI2_HBARC3
    neq = neq_fact * gt(thermal.neq_int, r1, w1)

    dn_bulk = np.zeros_like(neq)
    dn_diff = np.zeros_like(neq)

    if df_mode == 1:
        J10 = deg * T**3 / TWO_PI2_HBARC3 * gt(thermal.J10_int, r1, w1)
        J20 = deg * T**4 / TWO_PI2_HBARC3 * gt(thermal.J20_int, r2, w2)
        J30 = deg * T**5 / TWO_PI2_HBARC3 * gt(thermal.J30_int, r3, w3)
        J31 = deg * T**5 / TWO_PI2_HBARC3 / 3.0 * gt(thermal.J31_int, r3, w3)
        dn_bulk = ((df["c0"] - df["c2"]) * mass**2 * J10
                   + df["c1"] * baryon * J20
                   + (4.0 * df["c2"] - df["c0"]) * J30)
        dn_diff = baryon * df["c3"] * neq * T + df["c4"] * J31
    elif df_mode in (2, 3):
        J10 = deg * T**3 / TWO_PI2_HBARC3 * gt(thermal.J10_int, r1, w1)
        J11 = deg * T**3 / TWO_PI2_HBARC3 / 3.0 * gt(thermal.J11_int, r1, w1)
        J20 = deg * T**4 / TWO_PI2_HBARC3 * gt(thermal.J20_int, r2, w2)
        dn_bulk = (neq + baryon * J10 * df["G"] + J20 * df["F"] / T**2) / df["betabulk"]
        dn_diff = (neq * T * benth - baryon * J11) / df["betaV"]
    elif df_mode == 4:
        pass  # not needed for Jonah
    else:
        raise ValueError(f"df_mode must be 1-4, got {df_mode}")

    particle_table.equilibrium_density = neq
    particle_table.bulk_density = dn_bulk
    particle_table.diff_density = dn_diff
    return particle_table
