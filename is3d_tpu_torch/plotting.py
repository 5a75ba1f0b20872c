"""Plotting helpers (equivalents of scripts/plot_spectra.py,
compare_sampling_smooth.py, histogram_event.py); a copy of
is3d_tpu/plotting.py.  matplotlib is imported lazily, with the Agg backend,
and only here: no run path imports this module.  Every function returns
the Figure so callers can save or show."""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_spectra(spectra, grid, mcids, species_mcid, out=None):
    """log dN/(2 pi pT dpT dy) vs pT at midrapidity for one species."""
    plt = _mpl()
    from . import observables as obs
    mcids = np.asarray(mcids)
    i = int(np.nonzero(mcids == species_mcid)[0][0])
    vals = obs.dN_twopipTdpTdy(spectra, grid)[i, :, 0]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.semilogy(obs._np(grid.pT), np.maximum(vals, 1e-30), "-o", ms=3)
    ax.set_xlabel(r"$p_T$ [GeV]")
    ax.set_ylabel(r"$dN/(2\pi p_T dp_T dy)$ [GeV$^{-2}$]")
    ax.set_title(f"mcid {species_mcid}")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=150)
    return fig


def plot_sampling_vs_smooth(cmp: dict, species_mcid, out=None):
    """Overlay the sampled binned pT spectrum on the smooth curve
    (scripts/compare_sampling_smooth.py).  ``cmp`` comes from
    analysis.compare_sampling_smooth."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.semilogy(cmp["pT_smooth"], np.maximum(cmp["dN_2pipTdpTdy_smooth"], 1e-30),
                "-", label="smooth CF")
    sel = cmp["dN_2pipTdpTdy_sampled"] > 0
    ax.semilogy(cmp["pT_sampled"][sel], cmp["dN_2pipTdpTdy_sampled"][sel],
                "o", ms=3, label="sampled")
    ax.set_xlabel(r"$p_T$ [GeV]")
    ax.set_ylabel(r"$dN/(2\pi p_T dp_T dy)$")
    ax.legend()
    ax.set_title(f"mcid {species_mcid}: dN/dy smooth "
                 f"{cmp['dN_dy_smooth']:.3g} vs sampled "
                 f"{cmp['dN_dy_sampled']:.3g}")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=150)
    return fig


def plot_event_histogram(events, key="yp", bins=50, out=None):
    """Histogram one kinematic quantity over all events
    (scripts/histogram_event.py)."""
    plt = _mpl()
    vals = np.concatenate([np.asarray(e[key]) for e in events])
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.hist(vals, bins=bins, histtype="step")
    ax.set_xlabel(key)
    ax.set_ylabel("count")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=150)
    return fig
