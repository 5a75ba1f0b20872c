"""Thermal momentum-space integrals over the hadron resonance gas.

Gauss-Laguerre evaluations of the equilibrium density and the J_rs moments
used by the linearized delta-f corrections (reference: src/cpp/gaussThermal.cpp).
All integrands are written in reduced variables pbar = p/T, mbar = m/T; the
generalized Gauss-Laguerre rule of order alpha absorbs pbar^alpha e^-pbar, so
each integrand carries a compensating e^{+pbar} factor exactly as in the
reference.

Host-side numpy: the only caller is the per-species density setup
(io/deltaf.compute_particle_densities), a handful of (species x 32)-point
quadratures.  Dimensionful prefactors (powers of T / two_pi2_hbarC3,
degeneracy) are applied by the callers (reference: deltafReader.cpp:536-650).
"""

from __future__ import annotations

import numpy as np


def _ebar(pbar, mbar):
    return np.sqrt(pbar * pbar + mbar * mbar)


def gauss_thermal(integrand, roots, weights, mbar, alphaB, baryon, sign):
    """sum_k w_k * integrand(r_k, ...) (reference: gaussThermal.cpp:7-15);
    species arguments broadcast against the appended quadrature axis."""
    pbar = np.asarray(roots)
    mbar, alphaB, baryon, sign = (np.asarray(a)[..., None]
                                  for a in (mbar, alphaB, baryon, sign))
    return np.sum(weights * integrand(pbar, mbar, alphaB, baryon, sign),
                  axis=-1)


# ---- integrands (reference: gaussThermal.cpp:19-85); quadrature alpha noted
#
# All forms are algebraically identical to the reference but written with
# exp() of non-positive arguments only, so they do not overflow in float32
# (Gauss-Laguerre roots reach pbar ~ 114; exp(114) = inf in f32):
#   e^pbar f_eq          = e^{pbar - x} / (1 + sign e^{-x}),   x = Ebar - chem
#   e^pbar f_eq f_eqbar  = e^{pbar - x} / (1 + sign e^{-x})^2
# with pbar - x <= chem bounded.

def _feq_w(pbar, mbar, alphaB, baryon, sign):
    """e^pbar / (e^{Ebar - chem} + sign), overflow-safe."""
    x = _ebar(pbar, mbar) - baryon * alphaB
    return np.exp(pbar - x) / (1.0 + sign * np.exp(-x))


def _ff_w(pbar, mbar, alphaB, baryon, sign):
    """e^{pbar + Ebar - chem} / (e^{Ebar - chem} + sign)^2, overflow-safe."""
    x = _ebar(pbar, mbar) - baryon * alphaB
    d = 1.0 + sign * np.exp(-x)
    return np.exp(pbar - x) / (d * d)


def neq_int(pbar, mbar, alphaB, baryon, sign):     # alpha = 1
    return pbar * _feq_w(pbar, mbar, alphaB, baryon, sign)


def J10_int(pbar, mbar, alphaB, baryon, sign):     # alpha = 1
    return pbar * _ff_w(pbar, mbar, alphaB, baryon, sign)


def J11_int(pbar, mbar, alphaB, baryon, sign):     # alpha = 1
    e = _ebar(pbar, mbar)
    return pbar**3 / (e * e) * _ff_w(pbar, mbar, alphaB, baryon, sign)


def J20_int(pbar, mbar, alphaB, baryon, sign):     # alpha = 2
    return _ebar(pbar, mbar) * _ff_w(pbar, mbar, alphaB, baryon, sign)


def J30_int(pbar, mbar, alphaB, baryon, sign):     # alpha = 3
    e = _ebar(pbar, mbar)
    return e * e / pbar * _ff_w(pbar, mbar, alphaB, baryon, sign)


def J31_int(pbar, mbar, alphaB, baryon, sign):     # alpha = 3
    return pbar * _ff_w(pbar, mbar, alphaB, baryon, sign)
