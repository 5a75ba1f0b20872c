"""Local-rest-frame geometry needed by the cell preparation.

Elementwise torch forms of the reference's velocity normalization,
shear-stress closure and diffusion completion (reference:
src/cpp/emissionfunction_smooth_kernels.cpp:137-193).

Conventions: Milne coordinates (tau, x, y, eta), metric
g = diag(1, -1, -1, -tau^2); u^mu contravariant with u^tau derived from
normalization; dsigma_mu covariant.
"""

from __future__ import annotations

import torch


def u_tau(ux, uy, un, tau):
    """u^tau from the timelike normalization u.u = 1."""
    return torch.sqrt(1.0 + ux * ux + uy * uy + (tau * un) ** 2)


def reconstruct_pimunu(pixx, pixy, pixn, piyy, piyn, ut, ux, uy, un, tau):
    """Rebuild the full contravariant pi^munu from the 5 stored components
    using pi.u = 0 and Tr(pi) = 0
    (reference: emissionfunction_smooth_kernels.cpp:159-171).
    Returns (pitt, pitx, pity, pitn, pinn)."""
    tau2 = tau * tau
    ut2, ux2, uy2 = ut * ut, ux * ux, uy * uy
    utperp2 = 1.0 + ux2 + uy2
    pinn = (pixx * (ux2 - ut2) + piyy * (uy2 - ut2)
            + 2.0 * (pixy * ux * uy + tau2 * un * (pixn * ux + piyn * uy))) \
        / (tau2 * utperp2)
    pitn = (pixn * ux + piyn * uy + tau2 * pinn * un) / ut
    pity = (pixy * ux + piyy * uy + tau2 * piyn * un) / ut
    pitx = (pixx * ux + pixy * uy + tau2 * pixn * un) / ut
    pitt = (pitx * ux + pity * uy + tau2 * pitn * un) / ut
    return pitt, pitx, pity, pitn, pinn


def complete_Vmu(Vx, Vy, Vn, ut, ux, uy, un, tau):
    """V^tau from orthogonality V.u = 0
    (reference: emissionfunction_smooth_kernels.cpp:193)."""
    return (Vx * ux + Vy * uy + tau * tau * Vn * un) / ut
