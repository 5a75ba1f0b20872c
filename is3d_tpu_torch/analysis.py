"""Post-run analysis of sampled particle lists; numpy only, a copy of
is3d_tpu/analysis.py.

Library equivalents of the reference's analysis scripts (reference:
scripts/compute_observables.py -- hic-eventgen derived -- and
scripts/compare_sampling_smooth.py): identified-particle dN/dy, mean pT,
ALICE-cut pT fluctuations, flow Q-vectors, charged dNch/deta and dET/deta,
and the sampler-vs-smooth comparison arrays.  The events are the port's
(``IS3D.run_particlization().events``); the smooth spectra may be a torch
tensor on any device or a numpy array.
"""

from __future__ import annotations

import numpy as np

# (name, |mc id|) identified species, reference compute_observables.py:25-33
IDENTIFIED_SPECIES = [
    ("pion", 211), ("kaon", 321), ("proton", 2212), ("Lambda", 3122),
    ("Sigma0", 3212), ("Xi", 3312), ("Omega", 3334),
]

# fallback charges by |mcid| for the common hadrons; pass a ParticleTable
# to is_charged/compute_observables for exact per-species charges
_CHARGED = {211, 321, 2212, 3222, 3112, 3312, 3334, 213, 323, 1114, 2214,
            2224, 3114, 3224, 411, 431}


def _concat(events, keys):
    return {k: (np.concatenate([np.asarray(e[k]) for e in events])
                if events else np.zeros(0)) for k in keys}


def is_charged(mcid, particle_table=None):
    """Charged-particle mask.  With a ParticleTable (io/pdg.py) the exact
    per-species charge column decides; the hard-coded fallback set covers
    only the common hadrons and undercounts charged resonances (e.g.
    N(1440)+, a1(1260)+, Xi(1530)-)."""
    mcid = np.asarray(mcid)
    if particle_table is not None:
        charge = {int(m): int(q) for m, q in
                  zip(np.asarray(particle_table.mc_id),
                      np.asarray(particle_table.charge))}
        return np.asarray([charge.get(int(m), 0) != 0 for m in mcid.ravel()],
                          dtype=bool).reshape(mcid.shape)
    return np.isin(np.abs(mcid), sorted(_CHARGED))


def pseudorapidity(px, py, pz):
    """Momentum pseudorapidity eta_p = asinh(pz / pT) (what experimental
    |eta| cuts mean).  NOT the event's spacetime rapidity 'eta' field,
    which locates the emission point (t = tau cosh eta, z = tau sinh eta,
    kernels/sample.py) -- a particle emitted at eta_s = 2 can fly at
    pseudorapidity 0 and vice versa."""
    pT = np.hypot(np.asarray(px), np.asarray(py))
    pz = np.asarray(pz)
    # an exactly-zero momentum (possible after the f16 D2H pack rounds a
    # soft hadron) counts at midrapidity instead of sign(0)*inf = NaN
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.arcsinh(np.where(pT > 0, pz / np.maximum(pT, 1e-300),
                                  np.sign(pz) * np.inf))
    return np.where((pT > 0) | (pz != 0), out, 0.0)


def compute_observables(events, n_flow: int = 8, particle_table=None) -> dict:
    """Event-ensemble observables (reference compute_observables.py:80-110).

    events: list of per-event dicts with mcid, E, px, py, pz (+eta, yp).
    particle_table: optional io/pdg.py ParticleTable for exact charges.
    Returns a dict mirroring the reference's results record.

    The |eta| cuts use momentum PSEUDORAPIDITY computed from (px, py, pz),
    matching the reference script's UrQMD input semantics -- not the
    sampled event's spacetime-rapidity 'eta' field.
    """
    nsamples = max(len(events), 1)
    cat = _concat(events, ("mcid", "px", "py", "pz", "E", "yp"))
    pT = np.hypot(cat["px"], cat["py"])
    mT2 = cat["E"] ** 2 - cat["pz"] ** 2
    ET = np.sqrt(np.maximum(mT2, 0.0)) * np.where(
        cat["E"] > 0, 1.0, 0.0)  # transverse energy ~ mT at midrapidity
    phi = np.arctan2(cat["py"], cat["px"])
    y = cat["yp"]
    abs_eta = np.abs(pseudorapidity(cat["px"], cat["py"], cat["pz"]))
    charged = is_charged(cat["mcid"], particle_table)
    abs_id = np.abs(cat["mcid"])
    midrap = np.abs(y) < 0.5

    out = dict(nsamples=nsamples)
    out["dNch_deta"] = np.count_nonzero(charged & (abs_eta < 0.5)) / nsamples
    ET_eta = 0.6
    out["dET_deta"] = ET[abs_eta < ET_eta].sum() / (2 * ET_eta) / nsamples

    out["dN_dy"] = {}
    out["mean_pT"] = {}
    for name, mid in IDENTIFIED_SPECIES:
        cut = (abs_id == mid) & midrap
        N = np.count_nonzero(cut)
        out["dN_dy"][name] = N / nsamples
        out["mean_pT"][name] = 0.0 if N == 0 else float(pT[cut].mean())

    pT_alice = pT[charged & (abs_eta < 0.8) & (0.15 < pT) & (pT < 2.0)]
    out["pT_fluct"] = dict(N=int(pT_alice.size), sum_pT=float(pT_alice.sum()),
                           sum_pTsq=float(np.inner(pT_alice, pT_alice)))

    phi_alice = phi[charged & (abs_eta < 0.8) & (0.2 < pT) & (pT < 5.0)]
    out["flow"] = dict(
        N=int(phi_alice.size),
        Qn=np.asarray([np.exp(1j * n * phi_alice).sum()
                       for n in range(1, n_flow + 1)]))
    return out


def compare_sampling_smooth(hist: dict, spectra, grid, mcids, species_mcid,
                            cfg) -> dict:
    """Sampler-vs-smooth overlay arrays for one species (the reference's
    validation harness, scripts/compare_sampling_smooth.py).  ``hist`` is
    histograms.sampler_test_histograms of the events over ``mcids``, whose
    rows ``spectra`` (S, PT, PHI, Y) and ``grid`` (io/tables.MomentumGrid)
    share.

    Returns binned sampled dN/(2 pi pT dpT dy) + the smooth curve evaluated
    on the same pT points, and the dN/dy pair.  In 3+1D the smooth side is
    taken at the y node closest to midrapidity (the reference script
    selects the y == 0 rows), not at the grid's first (edge) node.
    """
    from . import observables as obs

    mcids = np.asarray(mcids)
    i = int(np.nonzero(mcids == species_mcid)[0][0])
    iy = (0 if cfg.dimension == 2
          else int(np.argmin(np.abs(obs._np(grid.y)))))
    smooth_pT = obs.dN_twopipTdpTdy(spectra, grid)[i, :, iy]
    smooth_dNdy = obs.dN_dy(spectra, grid)[i, iy]
    return dict(
        pT_sampled=hist["pT_mid"],
        dN_2pipTdpTdy_sampled=hist["dN_2pipTdpTdy"][i],
        pT_smooth=obs._np(grid.pT),
        dN_2pipTdpTdy_smooth=smooth_pT,
        dN_dy_sampled=hist["dN_dy_avg"][i],
        dN_dy_smooth=smooth_dNdy,
        vn_sampled=hist["vn"][i],
    )
