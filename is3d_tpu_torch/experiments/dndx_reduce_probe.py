"""The per-cell dN/dX reduction probe: the probe instantiation of the
dN/dX kernel (csrc/dndx.cu, ProbeProducer) beside its plain torch version.

Counterpart of experiments/probe_dndx_reduce.py::make_pallas_percell (P2):
for a synthetic producer q = 1/(e^x + 1) (1 + 0.1 x) w(s, m) with
x = a(c, r) b(s, m) + 0.3 a(c, r) it computes

    per_cell (C, S) = Σ_r wR_r Σ_m wM_m q,   sr (S, R) = Σ_c Σ_m wM_m q

from a (C, R), b (S, M), w (S, M), wM (M,), wR (R,).  The dN/dX kernel
runs the same reduction with the real emission function as its producer.
Time it on the card at P2's shape (C = 176, R = 48, S = 320, M = 768,
float32)::

    python -m is3d_tpu_torch.experiments.dndx_reduce_probe
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import dndx
from ..kernels.common import effective_chunk
from ..kernels.launch import (check_float, check_tensor, require_cuda, launch,
                              resident_blocks)

C, R, S, M = 176, 48, 320, 768

# (FP32, SFU) per (cell, node, species, point) evaluation for the bound,
# counted in the producer's formula as kernels/smooth.py counts the
# emission's (terms of fewer indices hoisted): x = a (b + 0.3) 1 | exp
# (SFU), + 1 1 | 1/(...) (SFU), (1 + 0.1 x) w wM = 0.1 a (b + 0.3) w wM +
# w wM 1, and the sum over points 1
BOUND_OPS = (4, 2)

# launches of the kernel in this process (percell_probe_cuda)
LAUNCHES = 0


def probe_inputs(n_cells: int = C, n_nodes: int = R, n_species: int = S,
                 n_points: int = M, seed: int = 0, dtype=torch.float32,
                 device="cpu") -> dict:
    """P2's input distributions (make_args), drawn with numpy."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        a=rng.normal(0.0, 1.0, (n_cells, n_nodes)) * 0.1,
        b=rng.normal(0.0, 1.0, (n_species, n_points)) * 0.1 + 1.0,
        w=rng.uniform(0.0, 1.0, (n_species, n_points)),
        wM=np.linspace(0.5, 1.5, n_points), wR=np.linspace(0.5, 1.5, n_nodes))
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in arrays.items()}


def percell_probe_plain(a, b, w, wM, wR,
                        cell_chunk: int = 65536) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Plain torch version (the port of P2's v_einsum_m reference,
    probe_dndx_reduce.py:58-61): (per_cell (C, S), sr (S, R))."""
    n_cells, n_nodes = a.shape
    chunk = effective_chunk(cell_chunk, n_cells, n_nodes * b.numel())
    per_cell, sr = [], None
    for c0 in range(0, n_cells, chunk):
        av = a[c0:c0 + chunk, :, None, None]
        x = av * b[None, None] + 0.3 * av
        q = 1.0 / (torch.exp(x) + 1.0) * (1.0 + 0.1 * x) * w[None, None]
        t = torch.einsum("crsm,m->crs", q, wM)
        per_cell.append(torch.einsum("crs,r->cs", t, wR))
        part = t.sum(0).T
        sr = part if sr is None else sr.add_(part)
    return torch.cat(per_cell).contiguous(), sr.contiguous()


def percell_probe_cuda(a, b, w, wM, wR) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the probe instantiation of csrc/dndx.cu on the current
    stream: (per_cell (C, S), sr (S, R)) in a's dtype."""
    global LAUNCHES
    check_float("percell_probe_cuda", a)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be matrices, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    n_cells, n_nodes = a.shape
    n_species, n_points = b.shape
    for name, t, shape in (("a", a, (n_cells, n_nodes)),
                           ("b", b, (n_species, n_points)),
                           ("w", w, (n_species, n_points)),
                           ("wM", wM, (n_points,)), ("wR", wR, (n_nodes,))):
        check_tensor(name, t, shape, a)
    dndx.cells_per_batch(n_nodes)
    require_cuda("percell_probe_cuda", a)
    lib = dndx._library()
    f64 = a.dtype == torch.float64
    slots = resident_blocks(lib, "dndx_probe",
                            lib.is3d_dndx_probe_slots_f64 if f64
                            else lib.is3d_dndx_probe_slots_f32, a.device)
    per, n_split = dndx.cell_split(n_cells, n_species, n_nodes, slots)
    per_cell = a.new_empty((n_cells, n_species))
    sr = a.new_empty((n_species, n_nodes))
    partial = a.new_empty((n_split, n_species, n_nodes))
    fn = lib.is3d_dndx_probe_f64 if f64 else lib.is3d_dndx_probe_f32
    launch(lib, "dndx_probe", fn, a.device, a.data_ptr(), n_cells, n_nodes,
           b.data_ptr(), w.data_ptr(), n_species, n_points, wM.data_ptr(),
           wR.data_ptr(), per, per_cell.data_ptr(), sr.data_ptr(),
           partial.data_ptr())
    LAUNCHES += 1
    return per_cell, sr


def measure(seed: int = 0) -> dict:
    """On the card, float32 at P2's shape: the kernel against the plain
    version on the same inputs (one launch; the plain version's time,
    median of 5 after that call), then the experiment's run: one warm-up
    and the median of 5 (CUDA events).  ``launches`` counts the
    experiment's run."""
    from ..utils import cuda_median_ms
    x = probe_inputs(seed=seed, device="cuda")
    args = (x["a"], x["b"], x["w"], x["wM"], x["wR"])
    got = percell_probe_cuda(*args)
    plain = lambda: percell_probe_plain(*args)
    want = plain()
    torch.cuda.synchronize()
    plain_ms, plain_runs = cuda_median_ms(plain)
    n0 = LAUNCHES
    kern = lambda: percell_probe_cuda(*args)
    kern()
    torch.cuda.synchronize()
    ms, runs = cuda_median_ms(kern)
    return dict(got=got, want=want, ms=ms, runs=runs, plain_ms=plain_ms,
                plain_runs=plain_runs, launches=LAUNCHES - n0,
                evaluations=C * R * S * M,
                bytes=sum(t.numel() * t.element_size() for t in (*args, *got)),
                label=f"C={C} R={R} S={S} M={M}",
                plain_label="plain on the same inputs")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("dndx_reduce_probe needs a CUDA card")
    r = measure()
    errs = [(g.double() - w.double()).abs().max().item() / w.abs().max().item()
            for g, w in zip(r["got"], r["want"])]
    print(f"{torch.cuda.get_device_name(0)} | dndx probe {r['label']}: kernel {r['ms']:.3f} ms "
          f"({r['evaluations'] / r['ms'] * 1e3:.3e} evaluations/s), plain "
          f"{r['plain_ms']:.3f} ms; max|kernel - plain| / max {errs[0]:.2e} "
          f"(per cell), {errs[1]:.2e} (per node)")


if __name__ == "__main__":
    main()
