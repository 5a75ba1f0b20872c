"""Local-rest-frame geometry needed by the cell preparation.

Elementwise torch forms of the reference's velocity normalization,
shear-stress closure and diffusion completion (reference:
src/cpp/emissionfunction_smooth_kernels.cpp:137-193), and the Milne tetrad
with the LRF boost of pi^munu and the flow rapidity that the feqmod
momentum transform needs (reference: src/cpp/viscous_correction.cpp).

Conventions: Milne coordinates (tau, x, y, eta), metric
g = diag(1, -1, -1, -tau^2); u^mu contravariant with u^tau derived from
normalization; dsigma_mu covariant.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tensors import TensorContainer


@dataclass(frozen=True)
class MilneBasis(TensorContainer):
    """Orthonormal tetrad (U, X, Y, Z) built from u^mu
    (reference: viscous_correction.cpp:10-29).  Only the nonzero components
    are stored: X = (Xt, Xx, Xy, Xn), Y = (Yx, Yy), Z = (Zt, Zn)."""

    Xt: torch.Tensor
    Xx: torch.Tensor
    Xy: torch.Tensor
    Xn: torch.Tensor
    Yx: torch.Tensor
    Yy: torch.Tensor
    Zt: torch.Tensor
    Zn: torch.Tensor


def u_tau(ux, uy, un, tau):
    """u^tau from the timelike normalization u.u = 1."""
    return torch.sqrt(1.0 + ux * ux + uy * uy + (tau * un) ** 2)


def milne_basis(ut, ux, uy, un, tau) -> MilneBasis:
    uperp = torch.sqrt(ux * ux + uy * uy)
    utperp = torch.sqrt(1.0 + ux * ux + uy * uy)
    sinhL = tau * un / utperp
    coshL = ut / utperp

    # guard the transverse direction for cells with no transverse flow
    # (reference: viscous_correction.cpp:24-28)
    safe = uperp > 1.0e-5
    one = torch.ones_like(uperp)
    zero = torch.zeros_like(uperp)
    inv_uperp = torch.where(safe, 1.0 / torch.where(safe, uperp, one), zero)
    Xx = torch.where(safe, utperp * ux * inv_uperp, one)
    Xy = torch.where(safe, utperp * uy * inv_uperp, zero)
    Yx = torch.where(safe, -uy * inv_uperp, zero)
    Yy = torch.where(safe, ux * inv_uperp, one)

    return MilneBasis(
        Xt=uperp * coshL, Xx=Xx, Xy=Xy, Xn=uperp * sinhL / tau,
        Yx=Yx, Yy=Yy, Zt=sinhL, Zn=coshL / tau,
    )


def basis_orthonormality_residual(b: MilneBasis, ut, ux, uy, un, tau):
    """Max |residual| of the tetrad normalization/orthogonality relations
    (reference test: viscous_correction.cpp:31-59).  Returns a tensor."""
    tau2 = tau * tau
    res = [
        ut * ut - ux * ux - uy * uy - tau2 * un * un - 1.0,
        b.Xt * b.Xt - b.Xx * b.Xx - b.Xy * b.Xy - tau2 * b.Xn * b.Xn + 1.0,
        -b.Yx * b.Yx - b.Yy * b.Yy + 1.0,
        b.Zt * b.Zt - tau2 * b.Zn * b.Zn + 1.0,
        b.Xt * ut - b.Xx * ux - b.Xy * uy - tau2 * b.Xn * un,
        -b.Yx * ux - b.Yy * uy,
        b.Zt * ut - tau2 * b.Zn * un,
        -b.Xx * b.Yx - b.Xy * b.Yy,
        b.Xt * b.Zt - tau2 * b.Xn * b.Zn,
    ]
    return torch.stack([torch.abs(r) for r in res]).amax(dim=0)


def boost_pimunu_to_lrf(b: MilneBasis, pitt, pitx, pity, pitn,
                        pixx, pixy, pixn, piyy, piyn, pinn, tau):
    """pi_ij in the LRF: pi_ij = X_i . pi . X_j
    (reference: viscous_correction.cpp:121-142).
    Returns (pixx, pixy, pixz, piyy, piyz, pizz)_LRF."""
    tau2 = tau * tau
    Xt, Xx, Xy, Xn = b.Xt, b.Xx, b.Xy, b.Xn
    Yx, Yy, Zt, Zn = b.Yx, b.Yy, b.Zt, b.Zn

    pixx_LRF = (pitt * Xt * Xt + pixx * Xx * Xx + piyy * Xy * Xy
                + tau2 * tau2 * pinn * Xn * Xn
                + 2.0 * (-Xt * (pitx * Xx + pity * Xy) + pixy * Xx * Xy
                         + tau2 * Xn * (pixn * Xx + piyn * Xy - pitn * Xt)))
    pixy_LRF = (Yx * (-pitx * Xt + pixx * Xx + pixy * Xy + tau2 * pixn * Xn)
                + Yy * (-pity * Xt + pixy * Xx + piyy * Xy + tau2 * piyn * Xn))
    pixz_LRF = (Zt * (pitt * Xt - pitx * Xx - pity * Xy - tau2 * pitn * Xn)
                - tau2 * Zn * (pitn * Xt - pixn * Xx - piyn * Xy
                               - tau2 * pinn * Xn))
    piyy_LRF = pixx * Yx * Yx + 2.0 * pixy * Yx * Yy + piyy * Yy * Yy
    piyz_LRF = (-Zt * (pitx * Yx + pity * Yy)
                + tau2 * Zn * (pixn * Yx + piyn * Yy))
    pizz_LRF = -(pixx_LRF + piyy_LRF)
    return pixx_LRF, pixy_LRF, pixz_LRF, piyy_LRF, piyz_LRF, pizz_LRF


def boost_dsigma_to_lrf(b: MilneBasis, dat, dax, day, dan, ut, ux, uy, un):
    """dsigma in the LRF: (u.dsigma, -X.dsigma, -Y.dsigma, -Z.dsigma)
    (reference: viscous_correction.cpp:69-80)."""
    dst = dat * ut + dax * ux + day * uy + dan * un
    dsx = -(dat * b.Xt + dax * b.Xx + day * b.Xy + dan * b.Xn)
    dsy = -(dax * b.Yx + day * b.Yy)
    dsz = -(dat * b.Zt + dan * b.Zn)
    return dst, dsx, dsy, dsz


def dsigma_magnitude(dst, dsx, dsy, dsz):
    """(dsigma_space, dsigma_magnitude) = (|spatial part|, |u.dsigma| + space)
    -- the sampler's max effective volume (reference:
    viscous_correction.cpp:82-86)."""
    space = torch.sqrt(dsx * dsx + dsy * dsy + dsz * dsz)
    return space, torch.abs(dst) + space


def boost_Vmu_to_lrf(b: MilneBasis, Vt, Vx, Vy, Vn, tau):
    """Baryon diffusion in the LRF: V_i = -X_i . V
    (reference: viscous_correction.cpp:161-173)."""
    tau2 = tau * tau
    Vx_LRF = -Vt * b.Xt + Vx * b.Xx + Vy * b.Xy + tau2 * Vn * b.Xn
    Vy_LRF = Vx * b.Yx + Vy * b.Yy
    Vz_LRF = -Vt * b.Zt + tau2 * Vn * b.Zn
    return Vx_LRF, Vy_LRF, Vz_LRF


def boost_pLRF_to_lab(b: MilneBasis, ut, ux, uy, un, E_LRF, px_LRF, py_LRF,
                      pz_LRF):
    """LRF momentum -> contravariant lab (Milne) momentum
    (reference: emissionfunction.cpp:40-51).
    Returns (p^tau, p^x, p^y, p^eta)."""
    ptau = E_LRF * ut + px_LRF * b.Xt + pz_LRF * b.Zt
    px = E_LRF * ux + px_LRF * b.Xx + py_LRF * b.Yx
    py = E_LRF * uy + px_LRF * b.Xy + py_LRF * b.Yy
    pn = E_LRF * un + px_LRF * b.Xn + pz_LRF * b.Zn
    return ptau, px, py, pn


def flow_rapidity(tau, ut, un):
    """Longitudinal flow rapidity y_flow = atanh(tau u^eta / u^tau),
    sanitized for f32: extreme (or corrupted) longitudinal flow rounds
    tau*un/ut to exactly +-1, atanh returns inf, and a non-finite
    cosh(delta) then poisons whole cell chunks through the 0-mask
    multiplies (inf * 0 = NaN).  Clamp to the principal branch; the
    clamp bound keeps cosh(y_flow + 10 * eta_max) finite in f32."""
    x = tau * un / ut
    x = torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0),
                    -0.999999, 0.999999)
    return torch.atanh(x)


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
