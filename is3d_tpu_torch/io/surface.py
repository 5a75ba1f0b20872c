"""Freeze-out surface loading: the viscous-hydro file formats -> Surface.

Reimplements the reference's FO_data_reader (reference:
src/cpp/readindata.cpp:103-1196) for the VH formats.  Every reader

* parses whitespace-separated columns (native tokenizer, '#' lines skipped),
* converts natural hydro units (fm powers) to the GeV/fm mixed system via
  hbarC exactly as the reference does per format,
* computes the sigma-weighted surface averages of (T, E, P, muB, nB) that the
  reference writes to ``average_thermodynamic_quantities.dat``
  (readindata.cpp:272-316).

Parsing runs in numpy on the host; the Surface holds tensors on the
requested device.

Modes (readindata.cpp:133-144):
  0 old CPU/GPU-VH    1 CPU-VH (5 pi components)   2 VAH PL-match
  3 VAH PL,PT-match   4 old MUSIC boost-invariant  5 VH + thermal vorticity
  6 new public MUSIC  7 hic-eventgen
Modes 2 and 3 (anisotropic hydro) belong to a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..tensors import TensorContainer
from ..units import HBARC


@dataclass(frozen=True)
class Surface(TensorContainer):
    """SoA freeze-out surface (VH formats).

    VH runs use the 5 independent shear components (pixx..piyn); the full
    pi^munu is reconstructed per cell from u-orthogonality + tracelessness
    (reference: emissionfunction_smooth_kernels.cpp:159-171).  Optional blocks
    are None when the format / switches don't provide them.
    """

    tau: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    eta: torch.Tensor
    dat: torch.Tensor
    dax: torch.Tensor
    day: torch.Tensor
    dan: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    un: torch.Tensor
    E: torch.Tensor
    T: torch.Tensor
    P: torch.Tensor
    pixx: Optional[torch.Tensor] = None
    pixy: Optional[torch.Tensor] = None
    pixn: Optional[torch.Tensor] = None
    piyy: Optional[torch.Tensor] = None
    piyn: Optional[torch.Tensor] = None
    bulkPi: Optional[torch.Tensor] = None
    muB: Optional[torch.Tensor] = None
    nB: Optional[torch.Tensor] = None
    Vx: Optional[torch.Tensor] = None
    Vy: Optional[torch.Tensor] = None
    Vn: Optional[torch.Tensor] = None
    # thermal vorticity (mode 5)
    wtx: Optional[torch.Tensor] = None
    wty: Optional[torch.Tensor] = None
    wtn: Optional[torch.Tensor] = None
    wxy: Optional[torch.Tensor] = None
    wxn: Optional[torch.Tensor] = None
    wyn: Optional[torch.Tensor] = None

    @property
    def n_cells(self) -> int:
        return self.tau.shape[0]


@dataclass(frozen=True)
class ThermoAverages:
    """sigma-weighted surface averages (the reference's Plasma / side-channel
    file, readindata.cpp:90-100 and 272-316)."""

    temperature: float
    energy_density: float
    pressure: float
    baryon_chemical_potential: float
    net_baryon_density: float

    def write(self, path: str = "average_thermodynamic_quantities.dat"):
        with open(path, "w") as f:
            f.write(f"{self.temperature:.15g}\n{self.energy_density:.15g}\n"
                    f"{self.pressure:.15g}\n{self.baryon_chemical_potential:.15g}\n"
                    f"{self.net_baryon_density:.15g}")


# ----------------------------------------------------------------- parsing

def load_float_matrix(path: str, ncols: int) -> np.ndarray:
    """Whitespace-separated float file ('#' comments skipped) as a
    (-1, ncols) matrix: the flat token stream is reshaped, matching the
    reference's stream extraction, which ignores line structure."""
    with open(path) as f:
        text = f.read()
    from ..native import fast_parse_doubles
    flat = fast_parse_doubles(text.encode())
    if flat is None:
        if "#" in text:
            # strip mid-line comments too, matching the native tokenizer
            text = "\n".join(l.split("#", 1)[0] for l in text.splitlines())
        flat = np.array(text.split(), dtype=np.float64)
    if flat.size % ncols:
        first = next((l for l in text.splitlines() if l.split()), "")
        raise ValueError(
            f"token count {flat.size} not divisible by the {ncols} "
            f"columns this surface mode expects (file rows have "
            f"{len(first.split())} columns -- wrong `mode` for this file?)")
    return flat.reshape(-1, ncols)


def _dsigma_magnitude(tau, ux, uy, un, dat, dax, day, dan):
    """|u.dsigma| + sqrt(|(u.dsigma)^2 - dsigma.dsigma|)
    (reference: readindata.cpp:284-288)."""
    ut = np.sqrt(1.0 + ux**2 + uy**2 + (tau * un) ** 2)
    udsigma = ut * dat + ux * dax + uy * day + un * dan
    dsig2 = dat**2 - dax**2 - day**2 - (dan / tau) ** 2
    return np.abs(udsigma) + np.sqrt(np.abs(udsigma**2 - dsig2))


def surface_averages(surface: Surface) -> ThermoAverages:
    """sigma-weighted thermo averages of an in-memory Surface (the file
    readers compute the same during parsing, reference
    readindata.cpp:272-316); absent optional fields average as 0."""
    col = lambda v: 0.0 if v is None else v.detach().cpu().double().numpy()
    s = surface
    return _averages(col(s.tau), col(s.ux), col(s.uy), col(s.un),
                     col(s.dat), col(s.dax), col(s.day), col(s.dan),
                     col(s.T), col(s.E), col(s.P), col(s.muB), col(s.nB))


def _averages(tau, ux, uy, un, dat, dax, day, dan, T, E, P, muB, nB) -> ThermoAverages:
    w = _dsigma_magnitude(tau, ux, uy, un, dat, dax, day, dan)
    tot = w.sum()
    avg = lambda q: float((q * w).sum() / tot) if np.ndim(q) else float(q)
    return ThermoAverages(avg(T), avg(E), avg(P), avg(muB), avg(nB))


# ------------------------------------------------------------- mode readers
#
# Each reader returns (dict-of-numpy-columns, ThermoAverages).

def _read_vh_old(m, include_baryon, include_baryondiff, dimension):
    """mode 0 (readindata.cpp:148-318): tau x y eta | da(4) | u^mu(4) | E T P |
    pi^munu(10) | Pi | [muB] | [nB V^mu(4)] ; thermo x hbarC."""
    c = iter(range(m.shape[1]))
    col = lambda: m[:, next(c)]
    tau, x, y, eta = col(), col(), col(), col()
    dat, dax, day, dan = col(), col(), col(), col()
    _check_dan(dan, dimension, strict=True)      # mode 0 exits upstream
    _ut, ux, uy, un = col(), col(), col(), col()  # u^tau re-derived from normalization
    E, T, P = col() * HBARC, col() * HBARC, col() * HBARC
    for _ in range(4):                            # pi^{tau mu}: rebuilt per cell
        col()
    pixx, pixy, pixn, piyy, piyn = (col() * HBARC for _ in range(5))
    col()                                         # pi^{eta eta}: rebuilt per cell
    bulkPi = col() * HBARC
    muB = col() * HBARC if include_baryon else 0.0
    if include_baryondiff:
        nB, _Vt, Vx, Vy, Vn = col(), col(), col(), col(), col()
    else:
        nB = 0.0
        Vx = Vy = Vn = None
    avg = _averages(tau, ux, uy, un, dat, dax, day, dan, T, E, P, muB, nB)
    d = dict(tau=tau, x=x, y=y, eta=eta, dat=dat, dax=dax, day=day, dan=dan,
             ux=ux, uy=uy, un=un, E=E, T=T, P=P,
             pixx=pixx, pixy=pixy, pixn=pixn, piyy=piyy, piyn=piyn,
             bulkPi=bulkPi)
    _maybe_baryon(d, include_baryon, include_baryondiff, muB, nB, Vx, Vy, Vn, len(tau))
    return d, avg


def _read_vh(m, include_baryon, include_baryondiff, dimension, vorticity=False):
    """mode 1 (readindata.cpp:320-468) and mode 5 (470-549): tau x y eta |
    da(4) | ux uy un | E T P | pixx pixy pixn piyy piyn | Pi | [muB] |
    [nB (Vt if mode5) Vx Vy Vn] | [w(6) if mode 5]; thermo x hbarC."""
    c = iter(range(m.shape[1]))
    col = lambda: m[:, next(c)]
    tau, x, y, eta = col(), col(), col(), col()
    dat, dax, day, dan = col(), col(), col(), col()
    _check_dan(dan, dimension)
    ux, uy, un = col(), col(), col()
    E, T, P = col() * HBARC, col() * HBARC, col() * HBARC
    pixx, pixy, pixn, piyy, piyn = (col() * HBARC for _ in range(5))
    bulkPi = col() * HBARC
    muB = col() * HBARC if include_baryon else 0.0
    if include_baryondiff:
        nB = col()
        if vorticity:
            _Vt = col()
        Vx, Vy, Vn = col(), col(), col()
    else:
        nB = 0.0
        Vx = Vy = Vn = None
    d = dict(tau=tau, x=x, y=y, eta=eta, dat=dat, dax=dax, day=day, dan=dan,
             ux=ux, uy=uy, un=un, E=E, T=T, P=P,
             pixx=pixx, pixy=pixy, pixn=pixn, piyy=piyy, piyn=piyn,
             bulkPi=bulkPi)
    _maybe_baryon(d, include_baryon, include_baryondiff, muB, nB, Vx, Vy, Vn, len(tau))
    if vorticity:
        for name in ("wtx", "wty", "wtn", "wxy", "wxn", "wyn"):
            d[name] = col()
    avg = _averages(tau, ux, uy, un, dat, dax, day, dan, T, E, P, muB, nB)
    return d, avg


def _read_music(m, dimension, new_format: bool):
    """modes 4 / 6 (readindata.cpp:552-810): tau x y eta | da_mu/tau(4) |
    u^mu(4, u^eta*tau) | E T muB [muS muC] s | pi^munu(10) | Pi.
    da x tau; u^eta / tau; P = T*s - E; eta forced to 0; pi^{.eta} / tau per
    index; dan forced to 0 (mode 6) or zeroed if nonzero (mode 4)."""
    c = iter(range(m.shape[1]))
    col = lambda: m[:, next(c)]
    tau, x, y, _eta = col(), col(), col(), col()
    eta = np.zeros_like(tau)
    dat, dax, day, dan = col() * tau, col() * tau, col() * tau, col() * tau
    if new_format:
        dan = np.zeros_like(tau)
    elif dimension == 2:
        dan = np.zeros_like(tau)  # mode 4 zeroes nonzero dan (readindata.cpp:589-594)
    _ut, ux, uy = col(), col(), col()
    un = col() / tau
    E = col() * HBARC
    T = col() * HBARC
    muB = col() * HBARC
    if new_format:
        _muS, _muC = col(), col()
    s = col()
    P = s * T - E
    for _ in range(4):                            # pi^{tau mu}: rebuilt per cell
        col()
    pixx, pixy = col() * HBARC, col() * HBARC
    pixn = col() * HBARC / tau
    piyy = col() * HBARC
    piyn = col() * HBARC / tau
    col()                                         # pi^{eta eta}: rebuilt per cell
    bulkPi = col() * HBARC
    nB = 0.0
    avg = _averages(tau, ux, uy, un, dat, dax, day, dan, T, E, P, muB, nB)
    d = dict(tau=tau, x=x, y=y, eta=eta, dat=dat, dax=dax, day=day, dan=dan,
             ux=ux, uy=uy, un=un, E=E, T=T, P=P,
             pixx=pixx, pixy=pixy, pixn=pixn, piyy=piyy, piyn=piyn,
             bulkPi=bulkPi, muB=muB)
    return d, avg


def _read_hiceventgen(m, dimension):
    """mode 7 (readindata.cpp:1059-1196): tau x y eta | da_mu/tau(4) |
    vx vy vn | pi^munu(10, GeV/fm^3) | Pi | T E P muB (GeV units already).
    Adds the missing tau Jacobian on da; builds u from v; vn forced 0;
    pi^{xz,yz} / tau -> pi^{x eta,y eta}; pi^{t.} and pi^{zz} discarded."""
    c = iter(range(m.shape[1]))
    col = lambda: m[:, next(c)]
    tau, x, y, _eta = col(), col(), col(), col()
    eta = np.zeros_like(tau)
    dat, dax, day = col() * tau, col() * tau, col() * tau
    _dan_raw = col()
    dan = np.zeros_like(tau)
    vx, vy, _vn = col(), col(), col()
    denom = 1.0 - vx**2 - vy**2
    if np.any(denom <= 0):
        raise ValueError("superluminal flow: 1 - vx^2 - vy^2 <= 0")
    ut = np.sqrt(1.0 / denom)
    ux, uy = ut * vx, ut * vy
    un = np.zeros_like(tau)
    _pitt, _pitx, _pity, _pitz = col(), col(), col(), col()
    pixx, pixy = col(), col()
    pixn = col() / tau
    piyy = col()
    piyn = col() / tau
    _pizz = col()
    bulkPi = col()
    T, E, P, muB = col(), col(), col(), col()
    nB = 0.0
    avg = _averages(tau, ux, uy, un, dat, dax, day, dan, T, E, P, muB, nB)
    d = dict(tau=tau, x=x, y=y, eta=eta, dat=dat, dax=dax, day=day, dan=dan,
             ux=ux, uy=uy, un=un, E=E, T=T, P=P,
             pixx=pixx, pixy=pixy, pixn=pixn, piyy=piyy, piyn=piyn,
             bulkPi=bulkPi, muB=muB)
    return d, avg


def _check_dan(dan, dimension, strict: bool = False):
    """Nonzero dsigma_eta on a 2+1D surface.  The reference exits for
    mode 0 (readindata.cpp:183-187) but downgraded the check to a warning
    for modes 1/5 (commented-out exit(-1) at :357, :497), so only
    ``strict`` readers raise."""
    if dimension == 2 and np.any(dan != 0):
        msg = ("2+1d boost-invariant surface read-in: dsigma_eta is not "
               "zero (max |dan| = %g)" % float(np.max(np.abs(dan))))
        if strict:
            raise ValueError(msg)
        print(f"[is3d_tpu_torch] warning: {msg}")


def _maybe_baryon(d, include_baryon, include_baryondiff, muB, nB, Vx, Vy, Vn, n):
    if include_baryon:
        d["muB"] = muB if np.ndim(muB) else np.full(n, float(muB))
    if include_baryondiff:
        d["nB"] = nB if np.ndim(nB) else np.full(n, float(nB))
        d["Vx"], d["Vy"], d["Vn"] = Vx, Vy, Vn


# --------------------------------------------------------------- public API

_EXPECTED_BASE_COLS = {
    # mode: columns without optional baryon blocks
    0: 26, 1: 20, 4: 27, 5: 26, 6: 29, 7: 26,
}
_BARYON_EXTRA = {0: (1, 5), 1: (1, 4), 5: (1, 5)}
VAH_MODES = (2, 3)


def expected_columns(mode, include_baryon, include_baryondiff) -> int:
    if mode in VAH_MODES:
        raise NotImplementedError(
            f"surface mode {mode} (anisotropic hydro) is not ported yet: "
            "ROADMAP section 1, slice 8 (VAH and polarization)")
    if mode not in _EXPECTED_BASE_COLS:
        raise ValueError(f"unknown surface mode {mode}; valid modes are "
                         f"{sorted(_EXPECTED_BASE_COLS)} "
                         f"(reference: readindata.cpp:133-144)")
    n = _EXPECTED_BASE_COLS[mode]
    extra = _BARYON_EXTRA.get(mode, (0, 0))
    if include_baryon:
        n += extra[0]
    if include_baryondiff:
        n += extra[1]
    return n


def read_surface(path: str, mode: int, dimension: int = 2,
                 include_baryon: bool = False, include_baryondiff: bool = False,
                 dtype=torch.float64, device="cpu"):
    """Load a freeze-out surface file.  Returns (Surface, ThermoAverages)."""
    ncols = expected_columns(mode, include_baryon, include_baryondiff)
    m = load_float_matrix(path, ncols=ncols)

    if mode == 0:
        d, avg = _read_vh_old(m, include_baryon, include_baryondiff, dimension)
    elif mode == 1:
        d, avg = _read_vh(m, include_baryon, include_baryondiff, dimension)
    elif mode == 4:
        d, avg = _read_music(m, dimension, new_format=False)
    elif mode == 5:
        d, avg = _read_vh(m, include_baryon, include_baryondiff, dimension,
                          vorticity=True)
    elif mode == 6:
        d, avg = _read_music(m, dimension, new_format=True)
    else:
        d, avg = _read_hiceventgen(m, dimension)
    return surface_from_arrays(dtype=dtype, device=device, **d), avg


def surface_from_arrays(dtype=torch.float64, device="cpu", **cols) -> Surface:
    """JETSCAPE-style in-memory construction (reference: iS3D.cpp:27-72 reads
    21 columns: tau,x,y,eta, da(4), ux,uy,un, E,T,P, 5 pi components, Pi).
    Units are assumed already converted (GeV / GeV fm^-3)."""
    return Surface(**{k: torch.tensor(np.asarray(v, np.float64),
                                      dtype=dtype, device=device)
                      for k, v in cols.items() if v is not None})
