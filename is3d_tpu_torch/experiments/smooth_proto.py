"""The spectra prototype (df 2, 3+1D, regulate and outflow fixed on): the
hand-written CUDA kernel csrc/smooth_proto.cu beside its plain torch
version.

Counterpart of experiments/pallas_smooth_proto.py (P1, the Pallas
prototype of the spectra kernel), with the same inputs and output:

    cells (C, 34) in FIELDS order; mTf, mT2, mTpx, mTpy (S, M);
    pxf, pyf (1, M); m2, sign, bary (S, 1); yg (1, Y)
    -> out (S / s_tile, Y, s_tile, M), the cell sum of
       where(p.dsigma > 0, p.dsigma f_eq (1 + clip(df, -1, 1)), 0) * mask

Shapes are the arguments' (P1's module globals C, S, P, F, Y are the
defaults of ``proto_inputs``).  Time the kernel on the card at P1's shape
(C = 32768, S = 320, M = 32 x 24, Y = 21, float32)::

    python -m is3d_tpu_torch.experiments.smooth_proto
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels.common import effective_chunk
from ..kernels.launch import check_float, check_tensor, require_cuda, launch

# the prototype's cell column order (csrc/smooth_proto.cu `PField`)
FIELDS = ("tau", "dat", "dax", "day", "dan", "ut", "ux", "uy", "un", "T",
          "alphaB", "pitt", "pitx", "pity", "pitn", "pixx", "pixy", "pixn",
          "piyy", "piyn", "pinn", "Vt", "Vx", "Vy", "Vn", "benth",
          "bulkPi", "eta", "sc", "b0", "b1", "b2", "ibV", "mask")
NF = len(FIELDS)
IDX = {n: i for i, n in enumerate(FIELDS)}
S_TILE = 32
ARGS = ("cells", "mTf", "mT2", "mTpx", "mTpy", "pxf", "pyf", "m2", "sign",
        "bary", "yg")

# per (cell, species, momentum point, rapidity) evaluation of the float32
# kernel, counted in its sm_90a SASS (the cell loop's body: 61 FP32-pipe
# instructions, one ex2 and three reciprocals; 127 instructions in all)
FP32_PER_EVAL = 61
SFU_PER_EVAL = 4

# launches of the CUDA kernel in this process (proto_spectra_cuda)
LAUNCHES = 0


def proto_inputs(C: int = 32768, S: int = 320, P: int = 32, F: int = 24,
                 Y: int = 21, seed: int = 0, dtype=torch.float32,
                 device="cpu") -> dict:
    """P1's inputs, drawn as its main() draws them (numpy, ``seed``)."""
    M = P * F
    rng = np.random.default_rng(seed)
    cells = np.zeros((C, NF), np.float32)
    col = lambda n: (slice(None), IDX[n])
    cells[col("tau")] = rng.uniform(1, 10, C)
    cells[col("dat")] = rng.uniform(-0.1, 1, C)
    cells[col("dax")] = rng.uniform(-0.5, 0.5, C)
    cells[col("day")] = rng.uniform(-0.5, 0.5, C)
    cells[col("ux")] = rng.uniform(-0.8, 0.8, C)
    cells[col("uy")] = rng.uniform(-0.8, 0.8, C)
    cells[col("un")] = rng.uniform(-0.05, 0.05, C)
    cells[col("ut")] = np.sqrt(1 + cells[col("ux")] ** 2
                               + cells[col("uy")] ** 2
                               + (cells[col("tau")] * cells[col("un")]) ** 2)
    cells[col("T")] = rng.uniform(0.148, 0.162, C)
    cells[col("eta")] = rng.uniform(-3, 3, C)
    for n in ("pitt", "pitx", "pity", "pitn", "pixx", "pixy", "pixn",
              "piyy", "piyn", "pinn", "Vt", "Vx", "Vy", "Vn"):
        cells[col(n)] = rng.normal(0, 0.003, C)
    cells[col("bulkPi")] = rng.normal(0, 0.003, C)
    cells[col("sc")] = rng.uniform(1, 2, C)
    for n in ("b0", "b1", "b2"):
        cells[col(n)] = rng.uniform(0.1, 1, C)
    cells[col("ibV")] = rng.uniform(1, 2, C)
    cells[col("mask")] = 1.0

    mass = rng.uniform(0.14, 2.0, S).astype(np.float32)
    pT = np.linspace(0.1, 4.0, P).astype(np.float32)
    phi = np.linspace(0, 2 * np.pi, F, endpoint=False).astype(np.float32)
    px = (pT[:, None] * np.cos(phi)[None]).reshape(M)
    py = (pT[:, None] * np.sin(phi)[None]).reshape(M)
    mT = np.sqrt(mass[:, None] ** 2 + pT[None] ** 2)
    mTf = np.broadcast_to(mT[:, :, None], (S, P, F)).reshape(S, M)
    sign = np.where(rng.random(S) < 0.5, -1.0, 1.0).astype(np.float32)
    bary = rng.integers(-1, 2, S).astype(np.float32)
    yg = np.linspace(-5, 5, Y).astype(np.float32)
    arrays = dict(cells=cells, mTf=mTf, mT2=mTf * mTf, mTpx=mTf * px[None],
                  mTpy=mTf * py[None], pxf=px[None], pyf=py[None],
                  m2=(mass ** 2)[:, None], sign=sign[:, None],
                  bary=bary[:, None], yg=yg[None])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=dtype,
                            device=device) for k, v in arrays.items()}


def proto_spectra_plain(cells, mTf, mT2, mTpx, mTpy, pxf, pyf, m2, sign, bary,
                        yg, s_tile: int = S_TILE,
                        cell_chunk: int = 65536) -> torch.Tensor:
    """Plain torch version of the kernel (P1's body, :57-96) on the same
    inputs: (S / s_tile, Y, s_tile, M)."""
    S, M = mTf.shape
    Y = yg.shape[1]
    C = cells.shape[0]
    chunk = effective_chunk(cell_chunk, C, S * M)
    out = mTf.new_zeros((Y, S, M))
    for iy in range(Y):
        yv = yg[0, iy]
        for c0 in range(0, C, chunk):
            x = cells[c0:c0 + chunk]
            g = lambda n: x[:, IDX[n]].view(-1, 1, 1)
            ep = torch.exp(yv - g("eta"))
            em = 1.0 / ep
            ch = 0.5 * (ep + em)
            sh = 0.5 * (ep - em)
            t_sh = sh * g("tau")
            A1 = ch * g("dat") + sh * (g("dan") / g("tau"))
            B1 = ch * g("ut") - sh * (g("tau") * g("un"))
            C1 = (ch * ch * g("pitt") + t_sh * t_sh * g("pinn")
                  - 2.0 * ch * t_sh * g("pitn"))
            C2 = -2.0 * (ch * g("pitx") - t_sh * g("pixn"))
            C3 = -2.0 * (ch * g("pity") - t_sh * g("piyn"))
            D1 = ch * g("Vt") - t_sh * g("Vn")
            W1 = g("dax") * pxf + g("day") * pyf
            W2 = g("ux") * pxf + g("uy") * pyf
            C4 = (g("pixx") * pxf * pxf + g("piyy") * pyf * pyf
                  + 2.0 * g("pixy") * pxf * pyf)
            D2 = g("Vx") * pxf + g("Vy") * pyf
            pds = mTf * A1 + W1
            pdotu = mTf * B1 - W2
            pipp = mT2 * C1 + mTpx * C2 + mTpy * C3 + C4
            Vp = mTf * D1 - D2
            chem = bary * g("alphaB")
            feq = 1.0 / (torch.exp(pdotu / g("T") - chem) + sign)
            feqbar = 1.0 - sign * feq
            r = 1.0 / pdotu
            df = feqbar * (g("sc") * pipp * r
                           + (g("b0") * pdotu + g("b1") * bary
                              + g("b2") * (pdotu - m2 * r)) * g("bulkPi")
                           + (g("benth") - bary * r) * Vp * g("ibV"))
            df = torch.clamp(df, -1.0, 1.0)
            f = feq * (1.0 + df)
            contrib = torch.where(pds > 0.0, pds * f, 0.0) * g("mask")
            out[iy] += contrib.sum(0)
    return (out.reshape(Y, S // s_tile, s_tile, M).permute(1, 0, 2, 3)
            .contiguous())


def _library():
    from ..native.build import cuda_library
    lib = cuda_library("smooth_proto")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.is3d_smooth_proto_f32, lib.is3d_smooth_proto_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci] + [vp] * 10 + [ci] * 4 + [vp, vp]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def proto_spectra_cuda(cells, mTf, mT2, mTpx, mTpy, pxf, pyf, m2, sign, bary,
                       yg, s_tile: int = S_TILE) -> torch.Tensor:
    """Launch csrc/smooth_proto.cu on the current stream:
    (S / s_tile, Y, s_tile, M) in the cells' dtype."""
    global LAUNCHES
    check_float("proto_spectra_cuda", cells)
    check_tensor("cells", cells, (cells.shape[0], NF), cells)
    S, M = mTf.shape
    Y = yg.shape[-1]
    if S % s_tile:
        raise ValueError(f"{S} species are not a multiple of s_tile={s_tile}")
    shapes = dict(mTf=(S, M), mT2=(S, M), mTpx=(S, M), mTpy=(S, M),
                  pxf=(1, M), pyf=(1, M), m2=(S, 1), sign=(S, 1),
                  bary=(S, 1), yg=(1, Y))
    args = dict(mTf=mTf, mT2=mT2, mTpx=mTpx, mTpy=mTpy, pxf=pxf, pyf=pyf,
                m2=m2, sign=sign, bary=bary, yg=yg)
    for name, shape in shapes.items():
        check_tensor(name, args[name], shape, cells)
    require_cuda("proto_spectra_cuda", cells)
    out = cells.new_empty((S // s_tile, Y, s_tile, M))
    lib = _library()
    fn = (lib.is3d_smooth_proto_f32 if cells.dtype == torch.float32
          else lib.is3d_smooth_proto_f64)
    launch(lib, "smooth_proto", fn, cells.device, cells.data_ptr(),
           cells.shape[0], NF, *(args[n].data_ptr() for n in shapes), S, M,
           Y, s_tile, out.data_ptr())
    LAUNCHES += 1
    return out


def measure(C: int = 32768, plain_cells: int = 1024, seed: int = 0) -> dict:
    """On the card, float32 at P1's shape: the kernel against the plain
    version on the first ``plain_cells`` cells (one launch; the plain
    version's time there, median of 3 after that call), then the
    experiment's run: the kernel over all C cells, one warm-up and the
    median of 5 (CUDA events).  ``launches`` counts the experiment's run."""
    from ..utils import cuda_median_ms
    x = proto_inputs(C, seed=seed, device="cuda")
    sub = dict(x, cells=x["cells"][:plain_cells].contiguous())
    got = proto_spectra_cuda(*(sub[n] for n in ARGS))
    plain = lambda: proto_spectra_plain(*(sub[n] for n in ARGS))
    want = plain()
    torch.cuda.synchronize()
    plain_ms, plain_runs = cuda_median_ms(plain, n=3)
    n0 = LAUNCHES
    kern = lambda: proto_spectra_cuda(*(x[n] for n in ARGS))
    out = kern()
    torch.cuda.synchronize()
    ms, runs = cuda_median_ms(kern)
    S, M = x["mTf"].shape
    Y = x["yg"].shape[1]
    return dict(got=got, want=want, ms=ms, runs=runs, plain_ms=plain_ms,
                plain_runs=plain_runs, launches=LAUNCHES - n0,
                evaluations=C * S * M * Y,
                bytes=sum(t.numel() * t.element_size()
                          for t in (*x.values(), out)),
                label=f"{C} cells x {S} x {M} x {Y}",
                plain_label=f"plain on the first {plain_cells} cells")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("smooth_proto needs a CUDA card")
    r = measure()
    err = (r["got"].double() - r["want"].double()).abs().max().item()
    scale = r["want"].abs().max().item()
    print(f"{torch.cuda.get_device_name(0)} | smooth_proto {r['label']}: "
          f"{r['ms']:.3f} ms ({r['evaluations'] / r['ms'] * 1e3:.3e} "
          f"evaluations/s); {r['plain_label']} {r['plain_ms']:.3f} ms; "
          f"max|kernel - plain| {err:.3e} of max {scale:.3e}")


if __name__ == "__main__":
    main()
