"""High-level run orchestration: the IS3D-class equivalent.

Mirrors the reference's IS3D library API (reference: src/cpp/iS3D.{h,cpp}):
construct from a parameter file + data directories, feed a freeze-out surface
from file or from memory, run particlization, and read back results.  Every
tensor lives on the device given to ``IS3D(..., device=...)``; a request for
CUDA on a machine without it raises instead of running on the CPU.

The port runs operation 0 (dN/dX spacetime distributions) and operation 1
(smooth spectra) on viscous-hydro surfaces with linear delta-f (df 1-2);
the other paths raise NotImplementedError naming the ROADMAP slice that
ports them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import Config, load_config
from .data import species_from_table
from .io import pdg as pdg_io
from .io import deltaf as deltaf_io
from .io.surface import read_surface, surface_from_arrays, surface_averages, \
    ThermoAverages
from .io.tables import load_momentum_grid, native_momentum_grid
from . import writers


_CHOSEN_FILES = {1: "chosen_particles_urqmd_v3.3+.dat",
                 2: "chosen_particles.dat",
                 3: "chosen_particles_box.dat"}

_DTYPES = {"f64": torch.float64, "f32": torch.float32}


@dataclass
class RunResult:
    spectra: Optional[np.ndarray] = None        # (S, PT, PHI, Y)
    dN_dX: Optional[dict] = None                # operation 0
    mcids: Optional[np.ndarray] = None
    averages: Optional[ThermoAverages] = None


def resolve_device(device) -> torch.device:
    """The run's device.  CUDA must be present when asked for: there is no
    silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           "available (torch.cuda.is_available() is False)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def _not_ported(what: str, slice_name: str, cfg: Config):
    if cfg.operation == 0:
        # dN/dX (slice 7) runs VH df 1-2; its other halves come with the
        # slices that port their emission functions
        what = f"operation 0 (dN/dX) with {what}"
        slice_name += " (slice 7 ported dN/dX for viscous hydro, df 1-2)"
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP "
                              f"section 1, {slice_name}")


def check_supported(cfg: Config):
    """Raise NotImplementedError for every configuration this slice of the
    port does not run."""
    if cfg.operation == 2:
        _not_ported("operation 2 (sampler)", "slice 9", cfg)
    if cfg.operation not in (0, 1):
        raise ValueError(f"operation must be 0, 1 or 2, got {cfg.operation}")
    if cfg.mode in (2, 3):
        _not_ported(f"surface mode {cfg.mode} (VAH)", "slice 8", cfg)
    if cfg.mode == 5:
        _not_ported("surface mode 5 (spin polarization)", "slice 8", cfg)
    if cfg.df_mode in (3, 4):
        _not_ported(f"df_mode {cfg.df_mode} (feqmod)", "slice 6", cfg)
    if cfg.df_mode not in (1, 2):
        raise ValueError(f"df_mode must be 1-4, got {cfg.df_mode}")
    if cfg.operation == 1 and cfg.do_resonance_decays:
        _not_ported("do_resonance_decays=1 (feed-down)", "slice 4", cfg)
    if cfg.precision not in _DTYPES:
        raise ValueError(f"precision must be one of {sorted(_DTYPES)}, got "
                         f"{cfg.precision!r}")


class IS3D:
    """End-to-end runner.

    Typical use (file mode, reference layout)::

        run = IS3D.from_run_dir(".", device="cuda")
        result = run.run_particlization()

    Memory mode::

        run = IS3D(cfg, data_dir=..., device="cuda")
        run.read_fo_surf_from_memory(tau=..., x=..., ..., bulkPi=...)
        result = run.run_particlization()
    """

    def __init__(self, cfg: Config, data_dir: str = ".",
                 results_dir: Optional[str] = None,
                 chosen_file: Optional[str] = None, device="cuda",
                 mesh=None):
        if mesh is not None:
            _not_ported("mesh= (multi-GPU)", "slice 11", cfg)
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.results_dir = results_dir or os.path.join(data_dir, "results")
        self.chosen_file = chosen_file
        self.surface = None
        self.averages: Optional[ThermoAverages] = None
        self._dtype = _DTYPES[cfg.precision]
        self.timer = None

    # ------------------------------------------------------------ loading

    @classmethod
    def from_run_dir(cls, run_dir: str = ".", overrides: Optional[dict] = None,
                     **kw) -> "IS3D":
        cfg = load_config(path=os.path.join(run_dir, "iS3D_parameters.dat"),
                          overrides=overrides)
        return cls(cfg, data_dir=run_dir, **kw)

    def read_fo_surf_from_file(self, path: Optional[str] = None,
                               write_averages: bool = True):
        path = path or os.path.join(self.data_dir, "input/surface.dat")
        self.surface, self.averages = read_surface(
            path, mode=self.cfg.mode, dimension=self.cfg.dimension,
            include_baryon=bool(self.cfg.include_baryon),
            include_baryondiff=bool(self.cfg.include_baryondiff_deltaf),
            dtype=self._dtype, device=self.device)
        if write_averages:
            # side-channel file compatibility (reference:
            # readindata.cpp:313-316 <-> Plasma::load_thermodynamic_averages)
            self.averages.write(os.path.join(
                self.data_dir, "average_thermodynamic_quantities.dat"))
        return self

    def read_fo_surf_from_memory(self, **columns):
        """21-column VH memory interface (reference: iS3D.cpp:27-72), plus any
        further Surface fields.  Units: GeV / GeV fm^-3 (already converted)."""
        self.surface = surface_from_arrays(dtype=self._dtype,
                                           device=self.device, **columns)
        self.averages = surface_averages(self.surface)
        return self

    # ------------------------------------------------------------ pipeline

    def _prepare(self):
        """Host-side tables (PDG, df coefficients, densities) and the
        device-side species, grid and df data."""
        cfg = self.cfg
        if self.surface is None:
            self.read_fo_surf_from_file()

        particle_table = pdg_io.read_resonances(
            os.path.join(self.data_dir, "PDG"), cfg.hrg_eos)

        # built and used in f64 on the host, then moved to the run's device
        df_data = deltaf_io.build_deltaf_data(
            os.path.join(self.data_dir, "deltaf_coefficients"), cfg.hrg_eos,
            particle_table=particle_table, T_avg=self.averages.temperature,
            include_jonah=True)
        deltaf_io.compute_particle_densities(
            particle_table, cfg.df_mode, self.averages, df_data,
            include_baryon=bool(cfg.include_baryon))
        if cfg.include_baryon and self.surface.muB is not None:
            # the nonzero-muB bilinear path would silently extrapolate;
            # fail host-side like the reference (deltafReader.cpp:425)
            deltaf_io.validate_df_range(
                df_data, self.surface.T.double().cpu().numpy(),
                self.surface.muB.double().cpu().numpy())
        df_data = df_data.to(self.device, self._dtype)

        chosen_name = self.chosen_file or _CHOSEN_FILES[cfg.hrg_eos]
        chosen_path = os.path.join(self.data_dir, "PDG", chosen_name)
        if os.path.exists(chosen_path):
            mcids = pdg_io.load_chosen_mcids(chosen_path)
        else:  # fall back to every species in the table
            mcids = particle_table.mc_id
        idx = pdg_io.chosen_indices(particle_table, mcids,
                                    group_by_mass=bool(cfg.group_particles),
                                    skip_missing=True)
        species = species_from_table(particle_table, idx, dtype=self._dtype,
                                     device=self.device)
        chosen_mcids = particle_table.mc_id[idx]

        tables_dir = os.path.join(self.data_dir, "tables")
        if os.path.isdir(tables_dir):
            grid = load_momentum_grid(tables_dir, cfg.dimension,
                                      cfg.operation, dtype=self._dtype,
                                      device=self.device)
        else:
            grid = native_momentum_grid(cfg.dimension, dtype=self._dtype,
                                        device=self.device)
        return df_data, species, chosen_mcids, grid

    def run_particlization(self, write_files: bool = True,
                           timer=None) -> RunResult:
        from .utils import PhaseTimer
        timer = timer or PhaseTimer(verbose=False)
        self.timer = timer
        cfg = self.cfg
        if write_files:
            # the spectra writers append (reference ios_base::app parity);
            # a rerun into the same results_dir must not duplicate blocks
            writers.clean_results_dir(self.results_dir)
        with timer.phase("prepare (io, pdg, deltaf)"):
            df_data, species, mcids, grid = self._prepare()

        result = RunResult(mcids=np.asarray(mcids), averages=self.averages)
        if cfg.operation == 1:
            from .kernels.smooth import smooth_spectra
            with timer.phase("smooth spectra"):
                spectra = smooth_spectra(self.surface, species, grid,
                                         df_data, cfg)
                # the host copy waits for the device: the phase includes it
                result.spectra = spectra.cpu().numpy()
            if write_files:
                with timer.phase("writers"):
                    self._write_smooth_files(result.spectra, grid.to("cpu"),
                                             mcids, self.results_dir)
        else:
            from .kernels.dndx import spacetime_distributions
            with timer.phase("dN/dX spacetime"):
                # returns host arrays: the phase includes the device time
                result.dN_dX = spacetime_distributions(
                    self.surface, species, grid, df_data, cfg)
            if write_files:
                with timer.phase("writers"):
                    writers.write_spacetime_distributions(
                        result.dN_dX, mcids, self.results_dir)
        return result

    def _write_smooth_files(self, spectra, grid, mcids, results_dir):
        cfg = self.cfg
        os.makedirs(results_dir, exist_ok=True)
        writers.write_dN_pTdpTdphidy(spectra, grid, mcids, cfg.dimension,
                                     results_dir)
        writers.write_continuous_vn(spectra, grid, mcids, cfg.dimension,
                                    results_dir)
        writers.write_dN_dy(spectra, grid, mcids, cfg.dimension, results_dir,
                            compat_dndy=bool(cfg.reference_compat_dndy))
        writers.write_dN_dphidy(spectra, grid, mcids, cfg.dimension,
                                results_dir)
        writers.write_dN_twopipTdpTdy(spectra, grid, mcids, cfg.dimension,
                                      results_dir)
