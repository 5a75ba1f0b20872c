"""Sampler-test histograms (test_sampler = 1), numpy only; a copy of
is3d_tpu/histograms.py.

Event-averaged binned distributions of sampled particle lists, matching the
reference's in-loop binning (emissionfunction_sampling_kernels.cpp:31-150)
and writer normalizations (emissionfunction.cpp:903-1258): dN/dy, dN/deta,
dN/(2 pi pT dpT dy), vn(pT), dN/(tau dtau dy), dN/(2 pi r dr dy), and the
per-event yield list.  Host-side vectorized numpy over the compacted event
arrays (the reference bins inside the sampling loop to save memory; our
events are already compact).
"""

from __future__ import annotations

import numpy as np

from .observables import K_MAX


def _mid(lo, hi, n):
    w = (hi - lo) / n
    return lo + w * (np.arange(n) + 0.5), w


def sampler_test_histograms(events, mcids, cfg, mean_yield=0.0) -> dict:
    """Bin all events.  Returns a dict of per-species arrays keyed like the
    reference's output files, all normalized per event."""
    mcids = np.asarray(mcids)
    S = len(mcids)
    nev = max(len(events), 1)
    pos = {int(m): i for i, m in enumerate(mcids)}

    cat = {}
    for k in ("mcid", "yp", "eta", "px", "py", "tau", "x", "y"):
        cat[k] = np.concatenate([np.asarray(e[k]) for e in events]) \
            if events else np.zeros(0)
    sp = np.asarray([pos.get(int(m), -1) for m in cat["mcid"]])

    y_cut, eta_cut = cfg.y_cut, cfg.eta_cut
    y_mid, y_w = _mid(-y_cut, y_cut, cfg.y_bins)
    eta_mid, eta_w = _mid(-eta_cut, eta_cut, cfg.eta_bins)
    pT_mid, pT_w = _mid(cfg.pT_lower_cut, cfg.pT_upper_cut, cfg.pT_bins)
    tau_mid, tau_w = _mid(cfg.tau_min, cfg.tau_max, cfg.tau_bins)
    r_mid, r_w = _mid(cfg.r_min, cfg.r_max, cfg.r_bins)

    pT = np.hypot(cat["px"], cat["py"])
    phi = np.mod(np.arctan2(cat["py"], cat["px"]), 2.0 * np.pi)
    r = np.hypot(cat["x"], cat["y"])
    in_y = np.abs(cat["yp"]) <= y_cut

    out = dict(
        y_mid=y_mid, eta_mid=eta_mid, pT_mid=pT_mid, tau_mid=tau_mid,
        r_mid=r_mid, nevents=nev, mean_yield=mean_yield,
        dN_dy=np.zeros((S, cfg.y_bins)),
        dN_dy_avg=np.zeros(S),
        dN_deta=np.zeros((S, cfg.eta_bins)),
        dN_2pipTdpTdy=np.zeros((S, cfg.pT_bins)),
        vn=np.zeros((S, cfg.pT_bins, K_MAX)),
        vn_counts=np.zeros((S, cfg.pT_bins)),
        dN_taudtaudy=np.zeros((S, cfg.tau_bins)),
        dN_twopirdrdy=np.zeros((S, cfg.r_bins)),
        yield_list=np.asarray([len(np.asarray(e["mcid"])) for e in events],
                              dtype=np.int64),
    )

    for s in range(S):
        m = sp == s
        # dN/dy
        cnt, _ = np.histogram(cat["yp"][m], bins=cfg.y_bins,
                              range=(-y_cut, y_cut))
        out["dN_dy"][s] = cnt / (y_w * nev)
        out["dN_dy_avg"][s] = cnt.sum() / (2.0 * y_cut * nev)
        # dN/deta
        cnt, _ = np.histogram(cat["eta"][m], bins=cfg.eta_bins,
                              range=(-eta_cut, eta_cut))
        out["dN_deta"][s] = cnt / (eta_w * nev)
        # pT spectrum and vn within |yp| <= y_cut
        my = m & in_y
        cnt, _ = np.histogram(pT[my], bins=cfg.pT_bins,
                              range=(cfg.pT_lower_cut, cfg.pT_upper_cut))
        out["dN_2pipTdpTdy"][s] = cnt / (2.0 * np.pi * 2.0 * y_cut * pT_w
                                         * pT_mid * nev)
        out["vn_counts"][s] = cnt
        for k in range(K_MAX):
            re, _ = np.histogram(pT[my], bins=cfg.pT_bins,
                                 range=(cfg.pT_lower_cut, cfg.pT_upper_cut),
                                 weights=np.cos((k + 1) * phi[my]))
            im, _ = np.histogram(pT[my], bins=cfg.pT_bins,
                                 range=(cfg.pT_lower_cut, cfg.pT_upper_cut),
                                 weights=np.sin((k + 1) * phi[my]))
            with np.errstate(divide="ignore", invalid="ignore"):
                vn = np.where(cnt > 0, np.hypot(re, im) / np.maximum(cnt, 1),
                              0.0)
            out["vn"][s, :, k] = vn
        # spacetime
        cnt, _ = np.histogram(cat["tau"][my], bins=cfg.tau_bins,
                              range=(cfg.tau_min, cfg.tau_max))
        out["dN_taudtaudy"][s] = cnt / (tau_mid * tau_w * nev * 2.0 * y_cut)
        cnt, _ = np.histogram(r[my], bins=cfg.r_bins,
                              range=(cfg.r_min, cfg.r_max))
        out["dN_twopirdrdy"][s] = cnt / (2.0 * np.pi * r_mid * r_w * nev
                                         * 2.0 * y_cut)
    return out


def write_sampler_test(hist: dict, mcids, results_dir="results"):
    """Write the reference's test_sampler file tree
    (emissionfunction.cpp:903-1258)."""
    import os
    dirs = {
        "dN_dy": os.path.join(results_dir, "dN_dy"),
        "dN_deta": os.path.join(results_dir, "dN_deta"),
        "mom": os.path.join(results_dir, "momentum_distribution"),
        "vn": os.path.join(results_dir, "vn"),
        "dX": os.path.join(results_dir, "spacetime_distribution"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    for i, mcid in enumerate(np.asarray(mcids)):
        mcid = int(mcid)
        with open(f"{dirs['dN_dy']}/dN_dy_{mcid}_test.dat", "w") as f:
            for x, v in zip(hist["y_mid"], hist["dN_dy"][i]):
                f.write(f"{x:.6g}\t{v:.6g}\n")
        with open(f"{dirs['dN_dy']}/dN_dy_{mcid}_average_test.dat", "w") as f:
            f.write(f"{hist['dN_dy_avg'][i]:.6g}\n")
        with open(f"{dirs['dN_deta']}/dN_deta_{mcid}_test.dat", "w") as f:
            for x, v in zip(hist["eta_mid"], hist["dN_deta"][i]):
                f.write(f"{x:.6g}\t{v:.6g}\n")
        with open(f"{dirs['mom']}/dN_2pipTdpTdy_{mcid}_test.dat", "w") as f:
            for x, v in zip(hist["pT_mid"], hist["dN_2pipTdpTdy"][i]):
                f.write(f"{x:.6e}\t{v:.6e}\n")
        with open(f"{dirs['vn']}/vn_{mcid}_test.dat", "w") as f:
            for ipt, x in enumerate(hist["pT_mid"]):
                row = "\t".join(f"{hist['vn'][i, ipt, k]:.6e}"
                                for k in range(K_MAX))
                f.write(f"{x:.6e}\t{row}\n")
        with open(f"{dirs['dX']}/dN_taudtaudy_sampled_{mcid}_test.dat", "w") as f:
            for x, v in zip(hist["tau_mid"], hist["dN_taudtaudy"][i]):
                f.write(f"{x:.6e}\t{v:.6e}\n")
        with open(f"{dirs['dX']}/dN_twopirdrdy_sampled_{mcid}_test.dat", "w") as f:
            for x, v in zip(hist["r_mid"], hist["dN_twopirdrdy"][i]):
                f.write(f"{x:.6e}\t{v:.6e}\n")

    with open(os.path.join(results_dir, "mean_yield.dat"), "w") as f:
        f.write(f"{hist['mean_yield']}\n")
    with open(os.path.join(results_dir, "yield_list.dat"), "w") as f:
        f.write("sampled particle yield\n")
        for n in hist["yield_list"]:
            f.write(f"{int(n)}\n")
