"""Anisotropic-hydro (VAH) helper functions.

Conformal factorization approximation linking the longitudinal/equilibrium
pressure ratio PL/Peq to the momentum-anisotropy parameter a_L and the
effective temperature Lambda.  The rational fit coefficients and the R200
hypergeometric function are the published conformal-aHydro results the
reference tabulates (reference: src/cpp/arsenal.cpp:999-1061).

All functions are numpy-vectorized: they run on the host while the
surface loads (a copy of is3d_tpu.physics.anisotropic; the port imports
nothing of is3d_tpu).
"""

from __future__ import annotations

import numpy as np

# numerator/denominator coefficients of the a_L(PL/Peq) rational fit,
# lowest order first (reference: arsenal.cpp:999-1028)
_AL_NUM = np.array([
    2.307660683188896e-22, 1.7179667824677117e-16, 7.2725449826862375e-12,
    4.2846163672079405e-8, 0.00004757224421671691, 0.011776118846199547,
    0.7235583305942909, 11.582755440134724, 44.45243622597357,
    12.673594148032494, -33.75866652773691, 8.04299287188939,
    1.462901772148128, -0.6320131889637761, 0.048528166213735346,
])
_AL_DEN = np.array([
    5.595674409987461e-19, 8.059757191879689e-14, 1.2033043382301483e-9,
    2.9819348588423508e-6, 0.0015212379997299082, 0.18185453852532632,
    5.466199358534425, 40.1581708710626, 44.38310108782752,
    -55.213789667214364, 1.5449108423263358, 11.636087951096759,
    -4.005934533735304, 0.4703844693488544, -0.014599143701745957,
])

# Taylor expansion of t200(x) around x=0 (reference: arsenal.cpp:1050-1054)
_T200_TAYLOR = np.array([
    2.0, 0.6666666666666667, -0.1333333333333333, 0.05714285714285716,
    -0.031746031746031744, 0.020202020202020193, -0.013986013986013984,
    0.010256410256410262, -0.00784313725490196,
])


def aL_fit(pl_peq_ratio):
    """a_L as a function of PL/Peq (conformal factorization fit)."""
    x = np.asarray(pl_peq_ratio, dtype=np.float64)
    num = np.polynomial.polynomial.polyval(x, _AL_NUM)
    den = np.polynomial.polynomial.polyval(x, _AL_DEN)
    return num / den


def R200(aL):
    """R200(a_L) = a_L * t200(x), x = 1/a_L^2 - 1, the kinetic energy-density
    moment of the anisotropic distribution (reference: arsenal.cpp:1032-1061)."""
    aL = np.asarray(aL, dtype=np.float64)
    x = 1.0 / (aL * aL) - 1.0
    if np.any(x <= -1.0):
        raise ValueError("R200: x = 1/aL^2 - 1 out of bounds (<= -1)")
    delta = 0.01
    sx = np.sqrt(np.abs(x))
    with np.errstate(divide="ignore", invalid="ignore"):
        t_pos = 1.0 + (1.0 + x) * np.arctan(sx) / sx
        t_neg = 1.0 + (1.0 + x) * np.arctanh(sx) / sx
    t_mid = np.polynomial.polynomial.polyval(x, _T200_TAYLOR)
    t200 = np.where(x > delta, t_pos, np.where(x < -delta, t_neg, t_mid))
    return aL * t200
