"""Momentum-space observables derived from the smooth spectra.

Numpy equivalents of the reference's writer-side integrations
(emissionfunction.cpp:593-772, 1053-1136): dN/dphidy, dN/(2pi pT dpT dy),
dN/dy, the mean pT, and the continuous anisotropic-flow harmonics v_n(pT,
y).  They run on the host on the final (S, PT, PHI, Y) spectra; grid
tensors are read back with ``_np``.
"""

from __future__ import annotations

import numpy as np
import torch

K_MAX = 7  # v_1 .. v_7, reference emissionfunction.h K_MAX


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dN_dphidy(spectra, grid) -> np.ndarray:
    """(S, PT, PHI, Y) -> (S, PHI, Y): Gauss pT integral of pT * spectra
    (reference: emissionfunction.cpp:620-630)."""
    w = _np(grid.pT_weight) * _np(grid.pT)
    return np.einsum("spfy,p->sfy", _np(spectra), w)


def dN_twopipTdpTdy(spectra, grid) -> np.ndarray:
    """(S, PT, PHI, Y) -> (S, PT, Y): phi average / 2pi
    (reference: emissionfunction.cpp:662-676)."""
    return np.einsum("spfy,f->spy", _np(spectra),
                     _np(grid.phi_weight)) / (2.0 * np.pi)


def dN_dy(spectra, grid, include_pT_jacobian: bool = True) -> np.ndarray:
    """(S, PT, PHI, Y) -> (S, Y): full transverse-momentum integral
    dN/dy = int pT dpT dphi dN/(pT dpT dphi dy).

    The reference's write_dN_dy_toFile (emissionfunction.cpp:745-768)
    omits the pT Jacobian; pass include_pT_jacobian=False
    (cfg.reference_compat_dndy) to reproduce its files exactly."""
    pw = _np(grid.pT_weight)
    w = pw * _np(grid.pT) if include_pT_jacobian else pw
    return np.einsum("spfy,p,f->sy", _np(spectra), w, _np(grid.phi_weight))


def mean_pT(spectra, grid) -> np.ndarray:
    """(S, PT, PHI, Y) -> (S, Y): mean transverse momentum, the Gauss
    integral of pT^2 spectra over dN/dy (with its pT Jacobian); 0 where
    dN/dy is 0."""
    num = np.einsum("spfy,p,f->sy", _np(spectra),
                    _np(grid.pT_weight) * _np(grid.pT) ** 2,
                    _np(grid.phi_weight))
    den = dN_dy(spectra, grid)
    return num / np.where(den == 0.0, 1.0, den)


def continuous_vn(spectra, grid, k_max: int = K_MAX):
    """|V_n|(pT, y) for n = 1..k_max
    (reference: emissionfunction.cpp:1053-1136).

    Returns (vn, denominator) with vn shape (S, k_max, PT, Y); vn is zeroed
    where the phi-integrated denominator is below 1e-15."""
    spectra = _np(spectra)
    phi = _np(grid.phi)
    phi_w = _np(grid.phi_weight)
    ks = np.arange(1, k_max + 1, dtype=spectra.dtype)
    ang = ks[:, None] * phi[None, :]                       # (K, PHI)
    wcos = np.cos(ang) * phi_w[None, :]
    wsin = np.sin(ang) * phi_w[None, :]
    re = np.einsum("spfy,kf->skpy", spectra, wcos)
    im = np.einsum("spfy,kf->skpy", spectra, wsin)
    den = np.einsum("spfy,f->spy", spectra, phi_w)
    mag = np.sqrt(re * re + im * im)
    # guard at the same 1e-15 the zeroing mask uses; every |den| < 1e-15
    # bin is zeroed below, so outputs are unchanged
    vn = mag / np.where(np.abs(den) < 1.0e-15, 1.0, den)[:, None]
    vn = np.where(den[:, None] < 1.0e-15, 0.0, vn)
    return vn, den
