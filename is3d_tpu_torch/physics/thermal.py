"""Thermal momentum-space integrals over the hadron resonance gas.

Gauss-Laguerre evaluations of the equilibrium density and the J_rs moments
used by the linearized delta-f corrections (reference: src/cpp/gaussThermal.cpp).
All integrands are written in reduced variables pbar = p/T, mbar = m/T; the
generalized Gauss-Laguerre rule of order alpha absorbs pbar^alpha e^-pbar, so
each integrand carries a compensating e^{+pbar} factor exactly as in the
reference.

The integrals run in whichever library the inputs live in: torch tensors
stay in torch on their device (the feqmod renormalization and breakdown
test, per (cell, species), kernels/feqmod.py), plain numpy inputs in numpy
(the per-species density setup, io/deltaf.compute_particle_densities, a
handful of (species x 32)-point quadratures).  Dimensionful prefactors
(powers of T / two_pi2_hbarC3, degeneracy) are applied by the callers
(reference: deltafReader.cpp:536-650).
"""

from __future__ import annotations

import numpy as np
import torch


def _lib(*xs):
    """torch if any input is a tensor, else numpy."""
    return torch if any(isinstance(x, torch.Tensor) for x in xs) else np


def _ebar(pbar, mbar):
    return _lib(pbar, mbar).sqrt(pbar * pbar + mbar * mbar)


def _quadrature(integrand, roots, weights, *params):
    """sum_k w_k * integrand(r_k, *params), the species ``params``
    broadcast against the appended quadrature axis: in torch (the first
    tensor's dtype and device) if any input is a tensor, else numpy."""
    if _lib(roots, weights, *params) is torch:
        like = next(a for a in (roots, weights, *params)
                    if isinstance(a, torch.Tensor))
        cast = lambda a: torch.as_tensor(a, dtype=like.dtype,
                                         device=like.device)
        pbar, weights = cast(roots), cast(weights)
        params = [cast(a)[..., None] for a in params]
        return torch.sum(weights * integrand(pbar, *params), dim=-1)
    params = [np.asarray(a)[..., None] for a in params]
    return np.sum(weights * integrand(np.asarray(roots), *params), axis=-1)


def gauss_thermal(integrand, roots, weights, mbar, alphaB, baryon, sign):
    """sum_k w_k * integrand(r_k, ...) (reference: gaussThermal.cpp:7-15);
    species arguments broadcast against the appended quadrature axis."""
    return _quadrature(integrand, roots, weights, mbar, alphaB, baryon, sign)


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
    xp = _lib(x, sign)
    return xp.exp(pbar - x) / (1.0 + sign * xp.exp(-x))


def _ff_w(pbar, mbar, alphaB, baryon, sign):
    """e^{pbar + Ebar - chem} / (e^{Ebar - chem} + sign)^2, overflow-safe."""
    x = _ebar(pbar, mbar) - baryon * alphaB
    xp = _lib(x, sign)
    d = 1.0 + sign * xp.exp(-x)
    return xp.exp(pbar - x) / (d * d)


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


# ---- Jonah's isotropically-scaled moments (reference: gaussThermal.cpp:93-116)

def E_mod_int(pbar, mbar, lam, sign):              # alpha = 2
    scale2 = (1.0 + lam) ** 2
    return (_lib(pbar, mbar, lam).sqrt(pbar * pbar * scale2 + mbar * mbar)
            * _feq_w(pbar, mbar, 0.0, 0.0, sign))


def P_mod_int(pbar, mbar, lam, sign):              # alpha = 2
    scale2 = (1.0 + lam) ** 2
    xp = _lib(pbar, mbar, lam)
    return (pbar * pbar * scale2 / xp.sqrt(pbar * pbar * scale2 + mbar * mbar)
            * _feq_w(pbar, mbar, 0.0, 0.0, sign))


def gauss_mod(integrand, roots, weights, mbar, lam, sign):
    """Quadrature for the Jonah modified-EoS integrands
    (reference: gaussThermal.cpp:93-98)."""
    return _quadrature(integrand, roots, weights, mbar, lam, sign)
