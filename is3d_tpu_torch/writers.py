"""Reference-compatible results/*.dat writers for the smooth spectra, the
spin polarization, the spacetime distributions and the sampled particle
list.

File layouts mirror the reference's writer methods
(emissionfunction.cpp:381-772, 1053-1136,
emissionfunction_smooth_kernels.cpp:1404-1439): same column orders, block
separators, and number formatting, so downstream analysis scripts written
for the reference keep working.  Results arrive as host numpy arrays.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .observables import (_np, dN_dphidy, dN_twopipTdpTdy, dN_dy,
                          continuous_vn, K_MAX)


def _sci(v: float) -> str:
    # C's printf (native/fastio.cpp) keeps the sign of a NaN; Python's
    # format drops it
    if math.isnan(v) and math.copysign(1.0, v) < 0:
        return "-nan"
    return f"{v:.8e}"


def _write_sci_table(path: str, header: str | None, rows: np.ndarray,
                     blank_every: int):
    """Append ``rows`` (N, ncols) as tab-separated ``%.8e`` lines, one extra
    blank line after every ``blank_every`` rows (the reference writers'
    per-pT-block separators).

    Routes through the native C formatter (native/fastio.cpp
    write_sci_table) when available -- the pure-Python per-value loop is
    minutes for a full-list 3+1D results tree -- with a byte-identical
    Python fallback."""
    from .native.build import fast_write_sci_table
    _ensure_dir(path)
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    size_before = os.path.getsize(path) if os.path.exists(path) else 0
    if fast_write_sci_table(path, True, header, rows, blank_every):
        return
    # a failed native write may have appended partial bytes; rewind so the
    # fallback produces a clean block
    if os.path.exists(path) and os.path.getsize(path) != size_before:
        os.truncate(path, size_before)
    with open(path, "a") as f:
        if header:
            f.write(header)
        for i in range(rows.shape[0]):
            f.write("\t".join(_sci(v) for v in rows[i]) + "\n")
            if blank_every > 0 and (i + 1) % blank_every == 0:
                f.write("\n")


def _block_rows(ys, phis, pTs, vals):
    """Rows (y, phip, pT, value) in the reference writers' loop order
    (species-major, then y, phip, pT) from ``vals`` shaped (S, npT, nphi,
    ny); returns (S, ny*nphi*npT, 4) float64."""
    S = vals.shape[0]
    Y, P, T = len(ys), len(phis), len(pTs)
    out = np.empty((S, Y, P, T, 4), np.float64)
    out[..., 0] = np.asarray(ys, np.float64)[None, :, None, None]
    out[..., 1] = np.asarray(phis, np.float64)[None, None, :, None]
    out[..., 2] = np.asarray(pTs, np.float64)[None, None, None, :]
    out[..., 3] = vals.transpose(0, 3, 2, 1)     # (S, Y, P, T)
    return out.reshape(S, -1, 4)


def _ensure_dir(path: str):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


# every file pattern a writer in this module can produce; the spectra
# writers open in append mode (reference ios_base::app parity), so a rerun
# into the same results_dir must clear its previous outputs first
_OWNED_PATTERNS = (
    "dN_pTdpTdphidy.dat", "dN_pTdpTdphidy_*.dat",
    "dN_dpTdphidy.dat", "dN_dpTdphidy_*.dat",
    "dN_twopidpTdy_*.dat", "dN_dphidy_*.dat", "dN_twopipTdpTdy_*.dat",
    "dN_dy_*.dat", "vn_continuous/vn_*.dat",
    "St.dat", "Sx.dat", "Sy.dat", "Sn.dat", "Snorm.dat",
    "spacetime_distribution/dN_taudtaudy_*.dat",
    "spacetime_distribution/dN_twopirdrdy_*.dat",
    "spacetime_distribution/dN_twopitaurdtaudrdy_*.dat",
    "spacetime_distribution/dN_dydeta_*.dat",
    # operation 2: the OSCAR list and the test_sampler histogram tree
    # (histograms.write_sampler_test; the sampled *_sampled_*_test.dat
    # spacetime files are matched by the globs above)
    "particle_list_*.dat", "momentum_distribution/pT_pdf_*.dat",
    "dN_dy/dN_dy_*.dat", "dN_deta/dN_deta_*.dat",
    "momentum_distribution/dN_2pipTdpTdy_*.dat", "vn/vn_*.dat",
    "mean_yield.dat", "yield_list.dat",
)


def clean_results_dir(results_dir: str):
    """Remove previous writer outputs from ``results_dir`` (only files this
    module owns -- see _OWNED_PATTERNS -- never the whole tree)."""
    import glob
    if not os.path.isdir(results_dir):
        return
    for pat in _OWNED_PATTERNS:
        for f in glob.glob(os.path.join(results_dir, pat)):
            try:
                os.remove(f)
            except OSError:
                pass


def _y_values(grid, dimension: int):
    return [0.0] if dimension == 2 else [float(v) for v in _np(grid.y)]


def write_dN_pTdpTdphidy(spectra, grid, mcids, dimension, results_dir="results",
                         suffix=""):
    """results/dN_pTdpTdphidy[_MCID].dat
    (reference: emissionfunction.cpp:381-450).  Rows: y phip pT value, blank
    line after each phip block; per-species files carry a header."""
    spectra = np.asarray(spectra)
    ys = _y_values(grid, dimension)
    pTs = _np(grid.pT)
    phis = _np(grid.phi)

    rows = _block_rows(ys, phis, pTs, spectra)
    main_path = f"{results_dir}/dN_pTdpTdphidy{suffix}.dat"
    _write_sci_table(main_path, None, rows.reshape(-1, 4),
                     blank_every=len(pTs))
    for s, mcid in enumerate(mcids):
        path = f"{results_dir}/dN_pTdpTdphidy_{int(mcid)}{suffix}.dat"
        _write_sci_table(path, "y\tphip\tpT\tdN_pTdpTdphidy\n", rows[s],
                         blank_every=len(pTs))


def write_dN_dpTdphidy(spectra, grid, mcids, dimension, results_dir="results",
                       suffix=""):
    """results/dN_dpTdphidy[_resonance_decays].dat (reference:
    emissionfunction.cpp:490-591): the layout of dN_pTdpTdphidy.dat with the
    pT Jacobian in the value (dN/pTdpTdphidy * pT) and a header row."""
    spectra = np.asarray(spectra)
    ys = _y_values(grid, dimension)
    pTs = _np(grid.pT)
    phis = _np(grid.phi)
    rows = _block_rows(ys, phis, pTs, spectra * pTs[None, :, None, None])
    _write_sci_table(f"{results_dir}/dN_dpTdphidy{suffix}.dat",
                     "y\tphip\tpT\tdN_dpTdphidy\n", rows.reshape(-1, 4),
                     blank_every=len(pTs))


def write_dN_twopidpTdy(spectra, grid, mcids, dimension,
                        results_dir="results"):
    """results/dN_twopidpTdy_MCID.dat (reference: emissionfunction.cpp:
    684-727, its call site commented out upstream; is3d_tpu/writers.py:160):
    the phi-integrated dN/(2 pi dpT dy), dN_twopipTdpTdy times pT."""
    vals = dN_twopipTdpTdy(spectra, grid)
    ys = _y_values(grid, dimension)
    pTs = _np(grid.pT)
    rows = np.empty((len(mcids), len(ys), len(pTs), 3), np.float64)
    rows[..., 0] = np.asarray(ys, np.float64)[None, :, None]
    rows[..., 1] = np.asarray(pTs, np.float64)[None, None, :]
    rows[..., 2] = (vals * pTs[None, :, None]).transpose(0, 2, 1)
    for s, mcid in enumerate(mcids):
        path = f"{results_dir}/dN_twopidpTdy_{int(mcid)}.dat"
        _write_sci_table(path, None, rows[s].reshape(-1, 3),
                         blank_every=len(pTs))


def write_sampled_pT_pdf(events, mcids, cfg, results_dir="results"):
    """results/momentum_distribution/pT_pdf_MCID_test.dat (reference:
    emissionfunction.cpp:1008-1051, dead code upstream, its layout kept;
    is3d_tpu/writers.py:178): each species' event-summed dN/dpT
    histogram over [pT_lower_cut, pT_upper_cut) in pT_bins bins, divided
    by the bin width and the species' count, under a header line of that
    count."""
    nbins = int(cfg.pT_bins)
    lo, hi = float(cfg.pT_lower_cut), float(cfg.pT_upper_cut)
    width = (hi - lo) / nbins
    mids = lo + width * (np.arange(nbins) + 0.5)
    mcids = np.asarray(mcids)
    counts = np.zeros((len(mcids), nbins))
    totals = np.zeros(len(mcids), dtype=np.int64)
    for ev in events:
        if len(ev) == 0 or len(np.atleast_1d(ev["mcid"])) == 0:
            continue
        pT = np.hypot(np.asarray(ev["px"]), np.asarray(ev["py"]))
        ids = np.asarray(ev["mcid"])
        for s, mcid in enumerate(mcids):
            sel = ids == int(mcid)
            totals[s] += int(sel.sum())
            h, _ = np.histogram(pT[sel], bins=nbins, range=(lo, hi))
            counts[s] += h
    for s, mcid in enumerate(mcids):
        path = f"{results_dir}/momentum_distribution/pT_pdf_{int(mcid)}_test.dat"
        _ensure_dir(path)
        with open(path, "w") as f:
            f.write(f"{totals[s]}\n")
            norm = width * max(totals[s], 1)
            for ipT in range(nbins):
                f.write(f"{mids[ipT]:.6e}\t{counts[s, ipT] / norm:.6e}\n")


def write_dN_dphidy(spectra, grid, mcids, dimension, results_dir="results"):
    """results/dN_dphidy_MCID.dat (reference: emissionfunction.cpp:593-637)."""
    vals = dN_dphidy(spectra, grid)
    ys = _y_values(grid, dimension)
    phis = _np(grid.phi)
    rows = np.empty((len(mcids), len(ys), len(phis), 3), np.float64)
    rows[..., 0] = np.asarray(ys, np.float64)[None, :, None]
    rows[..., 1] = np.asarray(phis, np.float64)[None, None, :]
    rows[..., 2] = vals.transpose(0, 2, 1)
    for s, mcid in enumerate(mcids):
        path = f"{results_dir}/dN_dphidy_{int(mcid)}.dat"
        _write_sci_table(path, None, rows[s].reshape(-1, 3),
                         blank_every=len(phis))


def write_dN_twopipTdpTdy(spectra, grid, mcids, dimension, results_dir="results"):
    """results/dN_twopipTdpTdy_MCID.dat (reference: emissionfunction.cpp:639-682)."""
    vals = dN_twopipTdpTdy(spectra, grid)
    ys = _y_values(grid, dimension)
    pTs = _np(grid.pT)
    rows = np.empty((len(mcids), len(ys), len(pTs), 3), np.float64)
    rows[..., 0] = np.asarray(ys, np.float64)[None, :, None]
    rows[..., 1] = np.asarray(pTs, np.float64)[None, None, :]
    rows[..., 2] = vals.transpose(0, 2, 1)
    for s, mcid in enumerate(mcids):
        path = f"{results_dir}/dN_twopipTdpTdy_{int(mcid)}.dat"
        _write_sci_table(path, None, rows[s].reshape(-1, 3),
                         blank_every=len(pTs))


def write_dN_dy(spectra, grid, mcids, dimension, results_dir="results",
                compat_dndy: bool = False):
    """results/dN_dy_MCID.dat (reference: emissionfunction.cpp:729-772;
    that writer uses default float formatting -- no `scientific` manipulator,
    unlike the other writers -- hence %.8g here).  ``compat_dndy``
    (cfg.reference_compat_dndy) reproduces the reference's integral, which
    omits the pT Jacobian (see observables.dN_dy)."""
    vals = dN_dy(spectra, grid, include_pT_jacobian=not compat_dndy)
    ys = _y_values(grid, dimension)
    for s, mcid in enumerate(mcids):
        path = f"{results_dir}/dN_dy_{int(mcid)}.dat"
        _ensure_dir(path)
        with open(path, "a") as f:
            for iy, y in enumerate(ys):
                f.write(f"{y:.8g}\t{vals[s, iy]:.8g}\n")


def write_continuous_vn(spectra, grid, mcids, dimension, results_dir="results"):
    """results/vn_continuous/vn_MCID.dat
    (reference: emissionfunction.cpp:1053-1136): y pT v1..v7 rows."""
    vn, _ = continuous_vn(spectra, grid)
    ys = _y_values(grid, dimension)
    pTs = _np(grid.pT)
    rows = np.empty((vn.shape[0], len(ys), len(pTs), 2 + K_MAX), np.float64)
    rows[..., 0] = np.asarray(ys, np.float64)[None, :, None]
    rows[..., 1] = np.asarray(pTs, np.float64)[None, None, :]
    rows[..., 2:] = vn.transpose(0, 3, 2, 1)     # (S, Y, T, K)
    for s, mcid in enumerate(mcids):
        path = f"{results_dir}/vn_continuous/vn_{int(mcid)}.dat"
        _write_sci_table(path, None, rows[s].reshape(-1, 2 + K_MAX),
                         blank_every=len(pTs))


def write_polarization(St, Sx, Sy, Sn, Snorm, grid, dimension,
                       results_dir="results"):
    """results/S{t,x,y,n}.dat, normalized by Snorm (reference:
    emissionfunction.cpp:775-827); a point with Snorm == 0 writes 0, as
    kernels/polzn.polzn_normalize gives."""
    ys = _y_values(grid, dimension)
    pTs = _np(grid.pT)
    phis = _np(grid.phi)
    Snorm = _np(Snorm)
    Snorm = np.where(Snorm == 0.0, 1.0, Snorm)
    for name, arr in (("St", St), ("Sx", Sx), ("Sy", Sy), ("Sn", Sn)):
        rows = _block_rows(ys, phis, pTs, _np(arr) / Snorm)
        _write_sci_table(f"{results_dir}/{name}.dat", None,
                         rows.reshape(-1, 4), blank_every=len(pTs))


def write_particle_list_csv(events, results_dir="results"):
    """results/particle_list_{i}.dat, one CSV file an event (reference:
    emissionfunction.cpp:829-860; is3d_tpu/writers.py:298): a header, then
    mcid and tau, x, y, eta, E, px, py, pz as Python's %.8e, one hadron a
    line."""
    for ievent, ev in enumerate(events):
        path = f"{results_dir}/particle_list_{ievent + 1}.dat"
        _ensure_dir(path)
        with open(path, "w") as f:
            f.write("mcid,tau,x,y,eta,E,px,py,pz\n")
            for i in range(len(ev["mcid"])):
                f.write(f"{int(ev['mcid'][i])}," + ",".join(
                    f"{float(ev[k][i]):.8e}"
                    for k in ("tau", "x", "y", "eta", "E", "px", "py", "pz"))
                    + "\n")


def write_spacetime_distributions(dX: dict, mcids, results_dir="results"):
    """results/spacetime_distribution/{dN_taudtaudy,dN_twopirdrdy,
    dN_twopitaurdtaudrdy,dN_dydeta}_MCID.dat (reference:
    emissionfunction_smooth_kernels.cpp:1404-1439)."""
    d = os.path.join(results_dir, "spacetime_distribution")
    os.makedirs(d, exist_ok=True)
    tau_mid, r_mid, eta = dX["tau_mid"], dX["r_mid"], dX["eta"]
    for i, mcid in enumerate(np.asarray(mcids)):
        mcid = int(mcid)
        with open(f"{d}/dN_taudtaudy_{mcid}.dat", "w") as f:
            for it, tm in enumerate(tau_mid):
                f.write(f"{tm:.6e}\t{dX['dN_taudtaudy'][i, it]:.6e}\n")
        with open(f"{d}/dN_twopirdrdy_{mcid}.dat", "w") as f:
            for ir, rm in enumerate(r_mid):
                f.write(f"{rm:.6e}\t{dX['dN_twopirdrdy'][i, ir]:.6e}\n")
        with open(f"{d}/dN_twopitaurdtaudrdy_{mcid}.dat", "w") as f:
            for ir, rm in enumerate(r_mid):
                for it, tm in enumerate(tau_mid):
                    f.write(f"{tm:.6e}\t{rm:.6e}\t"
                            f"{dX['dN_twopitaurdtaudrdy'][i, it, ir]:.6e}\n")
        with open(f"{d}/dN_dydeta_{mcid}_{len(eta)}pt.dat", "w") as f:
            for ie, ev in enumerate(eta):
                f.write(f"{ev:.6e}\t{dX['dN_dydeta'][i, ie]:.6e}\n")


def write_particle_list_oscar(events, path="results/particle_list_osc.dat"):
    """OSCAR-style list for the UrQMD / SMASH afterburner (reference:
    emissionfunction.cpp:863-901): per event a ``# N`` header and rows
    ``mcid t x y z E px py pz`` at 16 significant digits; events with no
    hadron are skipped.  Through the native formatter
    (native/fastio.cpp:write_oscar_event) when it builds, else a
    byte-identical Python loop."""
    from .native.build import fast_write_oscar_event
    _ensure_dir(path)
    open(path, "w").close()          # truncate; events append
    first = True
    for ev in events:
        n = len(ev["mcid"])
        if n == 0:
            continue
        # a failed native write may have appended partial bytes: rewind so
        # the fallback writes a clean block
        size_before = os.path.getsize(path)
        if fast_write_oscar_event(path, append=not first, ev=ev):
            first = False
            continue
        if os.path.getsize(path) != size_before:
            os.truncate(path, size_before)
        with open(path, "a") as f:
            f.write(f"# {n}\n")
            for i in range(n):
                row = " ".join(f"{float(ev[k][i]):.16e}"
                               for k in ("t", "x", "y", "z", "E", "px", "py",
                                         "pz"))
                f.write(f"{int(ev['mcid'][i])} {row}\n")
        first = False
