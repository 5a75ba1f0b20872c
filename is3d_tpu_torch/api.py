"""High-level run orchestration: the IS3D-class equivalent.

Mirrors the reference's IS3D library API (reference: src/cpp/iS3D.{h,cpp}):
construct from a parameter file + data directories, feed a freeze-out surface
from file or from memory, run particlization, and read back results.  Every
tensor lives on the device given to ``IS3D(..., device=...)``; a request for
CUDA on a machine without it raises instead of running on the CPU.

The port runs operation 0 (dN/dX spacetime distributions) and operation 1
(smooth spectra, with the resonance-decay feed-down when
do_resonance_decays = 1) on viscous-hydro surfaces with linear delta-f (df
1-2) and modified equilibrium distributions (df 3-4), on anisotropic-hydro
surfaces (modes 2-3, the VAH emission) and on thermal-vorticity surfaces
(mode 5: the spin polarization, then the operation); operation 2 (the
Monte-Carlo sampler, with the event-level decay cascade when
do_resonance_decays = 1) on the viscous-hydro surfaces, df 1-4, and on the
anisotropic-hydro ones, with alias or binary-search draws, cell-chunked
above sampler_cell_chunk.

Multi-GPU runs (``mesh=``, a parallel.mesh.CellMesh: a torch.distributed
process group, one GPU a rank) take operations 0 and 1 on every surface
mode: every rank reads the whole surface, launches the canonical groups it
owns, folds every group's partial and holds the one-process result bit for
bit; the feed-down runs replicated on every rank, and only rank 0 writes
the results tree and the averages file (is3d_tpu/api.py:105, :245-278).
Operation 2 under a mesh of W > 1 ranks follows is3d_tpu's pod rule
(is3d_tpu/api.py:343-420; every port mesh is several processes): rank r
samples the events of ``event_partition=(r, W)`` through the one-device
sampler, the MC decays key on the global event (``event_offset``) under
one shared seed, and rank 0 merges the ranks' part files (OSCAR, on a
results_dir every rank sees) or histograms the events gathered from every
rank (test_sampler), so its files are the one-process files byte for
byte.  The
cell-sharded sampler is kernels.sample.sample_particles(mesh=) and
ensemble.oversample_run(mesh=).
"""

from __future__ import annotations

import dataclasses
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
    polarization: Optional[dict] = None         # mode 5
    events: Optional[list] = None               # operation 2
    sample_info: Optional[dict] = None          # operation 2: batch plan
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


def check_supported(cfg: Config):
    """Raise ValueError for a configuration no operation reads (operation,
    df_mode, precision); every valid one runs on one device."""
    if cfg.operation not in (0, 1, 2):
        raise ValueError(f"operation must be 0, 1 or 2, got {cfg.operation}")
    # df_mode must be valid on every surface; VAH (modes 2-3) ignores it
    if cfg.df_mode not in (1, 2, 3, 4):
        raise ValueError(f"df_mode must be 1-4, got {cfg.df_mode}")
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
                 chosen_file: Optional[str] = None, device=None,
                 mesh=None):
        if mesh is not None:
            from .parallel.mesh import check_mesh
            check_mesh(mesh)
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.device = self._run_device(device, mesh)
        self.data_dir = data_dir
        self.results_dir = results_dir or os.path.join(data_dir, "results")
        self.chosen_file = chosen_file
        self.surface = None
        self.averages: Optional[ThermoAverages] = None
        self._dtype = _DTYPES[cfg.precision]
        self.timer = None

    @staticmethod
    def _run_device(device, mesh) -> torch.device:
        """The run's device: ``device`` (default cuda), or with a mesh the
        rank's device, which ``device`` must name if given."""
        if mesh is None:
            return resolve_device("cuda" if device is None else device)
        if device is not None:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if dev != mesh.device:
                raise ValueError(f"device={device!r} is not the mesh's "
                                 f"rank device {mesh.device}")
        return resolve_device(mesh.device)

    def _writes(self) -> bool:
        """Only rank 0 of a mesh writes files (the ranks share the run
        dir)."""
        return self.mesh is None or self.mesh.rank == 0

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
        if (write_averages and self.cfg.mode in (0, 1, 4, 6, 7)
                and self._writes()):
            # side-channel file compatibility (reference:
            # readindata.cpp:313-316 <-> Plasma::load_thermodynamic_averages);
            # the reference's readers for modes 2, 3 and 5 never write it
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

    def _maybe_fill_vah_coefficients(self):
        """Opt-in (cfg.vah_coefficient_tables): fill MISSING per-cell VAH
        residual-df coefficients c0..c4 on mode-2/3 surfaces from
        deltaf_coefficients/vah, bilinear in (Lambda, aL).  The reference
        ships these tables but its C++ build never loads them (the kernel
        reads zero-filled FO_surf fields, emissionfunction.cpp:1409-1417);
        the interpolation follows the one component that ever consumed
        them, src/cuda/deltafReader.cu:208-283.  Columns already on the
        surface win; with the option off (default) absent columns stay zero
        and the vah_df_gate drops the chains."""
        cfg = self.cfg
        if not (cfg.vah_coefficient_tables and cfg.mode in (2, 3)):
            return
        s = self.surface
        if s is None or s.Lambda is None or s.aL is None:
            return
        missing = [k for k in deltaf_io.VAH_COEFF_NAMES
                   if getattr(s, k) is None]
        if not missing:
            return
        tables = deltaf_io.load_vah_coefficient_tables(
            os.path.join(self.data_dir, "deltaf_coefficients"))
        coeffs = deltaf_io.interpolate_vah_coefficients(
            tables, s.Lambda.double().cpu().numpy(),
            s.aL.double().cpu().numpy())
        self.surface = dataclasses.replace(s, **{
            k: torch.tensor(coeffs[k], dtype=s.tau.dtype, device=s.tau.device)
            for k in missing})

    def _prepare(self):
        """Host-side tables (PDG, df coefficients, densities) and the
        device-side species, grid and df data: (particle_table, df_data,
        species, chosen mcids, grid)."""
        cfg = self.cfg
        if self.surface is None:
            self.read_fo_surf_from_file()
        self._maybe_fill_vah_coefficients()

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
        if (cfg.include_baryon and cfg.df_mode in (1, 2, 3)
                and cfg.mode not in (2, 3) and self.surface.muB is not None):
            # the nonzero-muB bilinear path would silently extrapolate;
            # fail host-side like the reference (deltafReader.cpp:425).
            # VAH surfaces never read the VH table, so they are not checked
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
            if cfg.mode in (2, 3) and cfg.dimension == 2:
                # VAH surfaces take the mT-adaptive eta remap on table grids
                # too, as is3d_tpu does (is3d_tpu/api.py:214-223): fixed
                # nodes under-resolve the narrow anisotropic integrand at
                # high pT, and the reference's VAH kernel is dead code, so
                # there is no reference output to keep
                grid = dataclasses.replace(grid, eta_mT_rescale=True)
        else:
            grid = native_momentum_grid(cfg.dimension, dtype=self._dtype,
                                        device=self.device)
        return particle_table, df_data, species, chosen_mcids, grid

    def plasma(self) -> ThermoAverages:
        """The QGP state of the run: the surface averages, with T_switch
        for the temperature when set_FO_temperature = 1 (reference:
        emissionfunction.cpp:1318-1321; the df tables take the raw
        averages, as iS3D.cpp does)."""
        avg = self.averages
        if not self.cfg.set_FO_temperature:
            return avg
        return dataclasses.replace(avg, temperature=self.cfg.T_switch)

    def run_particlization(self, write_files: bool = True,
                           timer=None) -> RunResult:
        from .utils import PhaseTimer
        timer = timer or PhaseTimer(verbose=False)
        self.timer = timer
        cfg = self.cfg
        # operation 2 over ranks: every rank writes its part file, then
        # rank 0 merges them; it keeps the caller's flag
        want_files = write_files
        write_files = write_files and self._writes()
        if write_files:
            # the spectra writers append (reference ios_base::app parity);
            # a rerun into the same results_dir must not duplicate blocks
            writers.clean_results_dir(self.results_dir)
        with timer.phase("prepare (io, pdg, deltaf)"):
            particle_table, df_data, species, mcids, grid = self._prepare()

        result = RunResult(mcids=np.asarray(mcids), averages=self.averages)
        if cfg.mode == 5:
            # the polarization, then the operation on the vorticity surface
            # (is3d_tpu/api.py:262-284: the reference's own mode-5
            # polarization call is dead code, and it runs the operation)
            from .kernels.polzn import spin_polarization
            with timer.phase("spin polarization"):
                pol = spin_polarization(self.surface, species, grid, cfg,
                                        self.plasma(), mesh=self.mesh)
                # the host copies wait for the device: the phase includes it
                result.polarization = {k: v.cpu().numpy()
                                       for k, v in pol.items()}
            if write_files:
                p = result.polarization
                os.makedirs(self.results_dir, exist_ok=True)
                with timer.phase("polarization writers"):
                    writers.write_polarization(p["St"], p["Sx"], p["Sy"],
                                               p["Sn"], p["Snorm"], grid,
                                               cfg.dimension,
                                               self.results_dir)
        if cfg.operation == 1:
            with timer.phase("smooth spectra"):
                spectra = self._smooth_spectra(species, grid, df_data)
                # the host copy waits for the device: the phase includes it
                result.spectra = spectra.cpu().numpy()
            # before the dispatch: a copy to the host waits for the stream
            host_grid = grid.to("cpu")
            decayed = None
            if cfg.do_resonance_decays:
                from .kernels.decays import do_resonance_decays
                # the cascade is queued on the device and runs while the
                # host writes the smooth files; reading it back waits
                with timer.phase("resonance decays dispatch"):
                    decayed = do_resonance_decays(spectra, particle_table,
                                                  mcids, grid, cfg)
            if write_files:
                with timer.phase("writers"):
                    self._write_smooth_files(result.spectra, host_grid,
                                             mcids, self.results_dir)
            if decayed is not None:
                with timer.phase("resonance decays"):
                    result.spectra = decayed.cpu().numpy()
                if write_files:
                    with timer.phase("decay writers"):
                        self._write_decay_files(result.spectra, host_grid,
                                                mcids, self.results_dir)
        elif cfg.operation == 2:
            self._sample(result, particle_table, df_data, species, mcids,
                         timer, want_files)
        else:
            from .kernels.dndx import spacetime_distributions
            with timer.phase("dN/dX spacetime"):
                # returns host arrays: the phase includes the device time
                result.dN_dX = spacetime_distributions(
                    self.surface, species, grid, df_data, cfg,
                    mesh=self.mesh)
            if write_files:
                with timer.phase("writers"):
                    writers.write_spacetime_distributions(
                        result.dN_dX, mcids, self.results_dir)
        return result

    def _pod(self) -> bool:
        """A mesh of several ranks: operation 2 takes the pod rule."""
        return self.mesh is not None and self.mesh.size > 1

    def _sample(self, result, particle_table, df_data, species, mcids,
                timer, want_files):
        """Operation 2 (is3d_tpu/api.py:338-425): the sampled events,
        decayed with do_resonance_decays = 1 (not under test_sampler, whose
        histograms compare with the undecayed yield), then the OSCAR list
        or the test_sampler histograms.  Over ranks each samples its
        contiguous slice of the global events and the files are merged
        (module docstring)."""
        from .kernels.sample import sample_particles, _resolve_seed
        cfg = self.cfg
        pod = self._pod()
        write_files = want_files and self._writes()
        if pod and want_files and not cfg.test_sampler:
            # before the sampling: the OSCAR merge's part files need a
            # results_dir every rank sees
            self._check_pod_shared_fs()
        seed = _resolve_seed(None, cfg)
        info = {}
        with timer.phase("sampler"):
            # VAH surfaces (modes 2-3) never read the VH df tables
            result.events = sample_particles(
                self.surface, species, np.asarray(mcids),
                None if cfg.mode in (2, 3) else df_data, cfg,
                self.plasma(), seed=seed, info=info,
                event_partition=((self.mesh.rank, self.mesh.size) if pod
                                 else None))
        result.sample_info = info
        if cfg.do_resonance_decays and not cfg.test_sampler:
            from .kernels.mc_decays import decay_events, derive_decay_seed
            with timer.phase("MC resonance decays"):
                # the decay streams' own seed: the sampler's would key the
                # same counters
                info["decays"] = {}
                result.events = decay_events(
                    result.events, particle_table, cfg,
                    seed=derive_decay_seed(seed),
                    event_offset=info.get("event_lo", 0), device=self.device,
                    info=info["decays"])
        if not (write_files or (pod and want_files)):
            return
        if write_files or not cfg.test_sampler:
            os.makedirs(self.results_dir, exist_ok=True)
        with timer.phase("writers"):
            if cfg.test_sampler:
                from .histograms import (sampler_test_histograms,
                                         write_sampler_test)
                events = result.events
                if pod:
                    # the global event list, in rank order, on every rank
                    from .parallel.mesh import gather_objects
                    events = [e for part in gather_objects(events, self.mesh)
                              for e in part]
                if write_files:
                    hist = sampler_test_histograms(events, mcids, cfg,
                                                   info["total_yield"])
                    write_sampler_test(hist, mcids, self.results_dir)
                if pod:
                    from .parallel.mesh import barrier
                    barrier(self.mesh)
            elif pod:
                self._write_pod_oscar(result.events)
            else:
                writers.write_particle_list_oscar(
                    result.events,
                    os.path.join(self.results_dir, "particle_list_osc.dat"))

    def _check_pod_shared_fs(self):
        """Operation 2 over ranks with file output needs results_dir on a
        filesystem every rank sees (rank 0 merges the ranks' part files).
        Rank 0 writes a marker, every rank looks for it, and the verdicts
        are gathered so that every rank raises together, before the
        sampling (is3d_tpu/api.py:431-461)."""
        from .parallel.mesh import barrier, gather_objects
        marker = os.path.join(self.results_dir, ".is3d_pod_fs_probe")
        if self.mesh.rank == 0:
            os.makedirs(self.results_dir, exist_ok=True)
            with open(marker, "w") as f:
                f.write(str(self.mesh.size))
        barrier(self.mesh)
        seen = gather_objects(os.path.exists(marker), self.mesh)
        if self.mesh.rank == 0:
            os.remove(marker)
        bad = [r for r, ok in enumerate(seen) if not ok]
        if bad:
            raise RuntimeError(
                f"operation 2 over ranks with write_files: results_dir "
                f"'{self.results_dir}' is not visible to rank(s) {bad}; the "
                "part-file merge needs a filesystem every rank sees.  Point "
                "results_dir at shared storage, or run with "
                "write_files=False and write each rank's events yourself")

    def _part_path(self, stem: str, rank: int) -> str:
        return os.path.join(self.results_dir,
                            f"{stem}.part{rank}of{self.mesh.size}")

    def _write_pod_oscar(self, events_local):
        """The particle list over ranks: every rank writes its events to a
        part file, and after a barrier rank 0 streams the parts in rank
        order (= global event order) into particle_list_osc.dat, refusing
        on a missing part; OSCAR events are self-delimiting blocks, so the
        concatenation is the one-process file byte for byte
        (is3d_tpu/api.py:503-546).  Every rank waits for the merge."""
        import shutil
        from .parallel.mesh import barrier
        part = self._part_path("particle_list_osc", self.mesh.rank) + ".dat"
        writers.write_particle_list_oscar(events_local, part)
        barrier(self.mesh)
        if self.mesh.rank == 0:
            out = os.path.join(self.results_dir, "particle_list_osc.dat")
            parts = [self._part_path("particle_list_osc", r) + ".dat"
                     for r in range(self.mesh.size)]
            missing = [f for f in parts if not os.path.exists(f)]
            if missing:
                raise FileNotFoundError(
                    f"OSCAR merge: missing part file(s) {missing} after the "
                    "write barrier -- a rank failed to write its events")
            with open(out + ".tmp", "wb") as fo:
                for f in parts:
                    # streamed: a rank's list can be gigabytes
                    with open(f, "rb") as fi:
                        shutil.copyfileobj(fi, fo, 1 << 22)
            os.replace(out + ".tmp", out)
            for f in parts:
                os.remove(f)
        barrier(self.mesh)

    def _smooth_spectra(self, species, grid, df_data):
        """The smooth spectra of the surface and df mode (reference
        dispatch: is3d_tpu/api.py:712-736): VAH surfaces (modes 2-3)
        whatever df_mode, else by df mode; with a mesh VH surfaces through
        parallel.mesh.smooth_spectra_sharded (is3d_tpu/api.py:722-731)."""
        if self.cfg.mode in (2, 3):
            from .kernels.vah import smooth_spectra_vah
            return smooth_spectra_vah(self.surface, species, grid, self.cfg,
                                      mesh=self.mesh)
        if self.mesh is not None:
            from .parallel.mesh import smooth_spectra_sharded
            return smooth_spectra_sharded(self.surface, species, grid,
                                          df_data, self.cfg, mesh=self.mesh)
        if self.cfg.df_mode in (1, 2):
            from .kernels.smooth import smooth_spectra
            return smooth_spectra(self.surface, species, grid, df_data,
                                  self.cfg)
        from .kernels.feqmod import smooth_spectra_feqmod
        return smooth_spectra_feqmod(self.surface, species, grid, df_data,
                                     self.cfg)

    def run_ensemble(self, surfaces, write_files: bool = True,
                     pad_to: Optional[int] = None, timer=None) -> list:
        """Smooth spectra for an ensemble of freeze-out surfaces
        (is3d_tpu/api.py:571-706, operation 1 only): the event-by-event
        workflow the reference serves with one process per event.

        ``surfaces``: surface-file paths and/or ``Surface`` objects, all of
        this run's mode, dimension and df config.  The delta-f data is
        prepared once, from the first event's averages; every event's (T,
        muB) range is checked against the df tables (VH surfaces only, as
        the VAH path never reads them).  Each event runs the single-surface
        path (batch.smooth_spectra_batched), so its spectra are its own
        single run's bit for bit; mode-5 surfaces also get the batched
        polarization, each event at its own averaged temperature; the
        feed-down runs per event.  Results go to
        ``<results_dir>/event_<i>/`` in the reference formats (stale
        ``event_*`` trees of a larger earlier ensemble are cleaned);
        returns one RunResult per event, in order.

        With ``mesh=`` the event axis runs over the ranks (batch.py: whole
        events a rank, the rows gathered in event order; the event count
        must divide by the ranks), each event's feed-down on the rank that
        owns it; every rank returns the one-process results and only rank
        0 writes the trees."""
        from .utils import PhaseTimer
        from .batch import (stack_surfaces, smooth_spectra_batched,
                            event_layout, gather_events)
        timer = timer or PhaseTimer(verbose=False)
        cfg = self.cfg
        if cfg.operation != 1:
            raise ValueError("run_ensemble batches smooth spectra "
                             "(operation 1); for sampling ensembles use "
                             "ensemble.multiprocess_oversample")

        loaded, averages = [], []
        with timer.phase("load surfaces"):
            for s in surfaces:
                if isinstance(s, (str, os.PathLike)):
                    surf, avg = read_surface(
                        s, mode=cfg.mode, dimension=cfg.dimension,
                        include_baryon=bool(cfg.include_baryon),
                        include_baryondiff=bool(cfg.include_baryondiff_deltaf),
                        dtype=self._dtype, device=self.device)
                else:
                    surf, avg = s, surface_averages(s)
                loaded.append(surf)
                averages.append(avg)
        if not loaded:
            raise ValueError("run_ensemble needs at least one surface")
        # an event count the ranks do not divide fails before any work
        layout = (None if self.mesh is None or self.mesh.size == 1
                  else event_layout(len(loaded), self.mesh))
        write_files = write_files and self._writes()

        self.surface, self.averages = loaded[0], averages[0]
        with timer.phase("prepare (io, pdg, deltaf)"):
            particle_table, df_data, species, mcids, grid = self._prepare()
        self.timer = timer
        # _prepare checked the first event's (T, muB) only
        if (cfg.include_baryon and cfg.df_mode in (1, 2, 3)
                and cfg.mode not in (2, 3)):
            host_df = df_data.to("cpu", torch.float64)
            for surf in loaded[1:]:
                if surf.muB is not None:
                    deltaf_io.validate_df_range(
                        host_df, surf.T.double().cpu().numpy(),
                        surf.muB.double().cpu().numpy())

        if write_files:
            # a previous, larger ensemble may have written more event_<i>
            # trees here; clean them so globs over event_*/ see this run
            import glob
            for d in glob.glob(os.path.join(self.results_dir, "event_*")):
                tail = os.path.basename(d)[len("event_"):]
                if tail.isdigit() and int(tail) >= len(loaded):
                    writers.clean_results_dir(d)  # owned files only
                    try:
                        os.rmdir(d)
                    except OSError:
                        pass  # user files live there: keep the directory

        with timer.phase("stack + batched spectra"):
            stacked = stack_surfaces(loaded, pad_to=pad_to,
                                     dtype=self._dtype)
            spectra_dev = smooth_spectra_batched(stacked, species, grid,
                                                 df_data, cfg,
                                                 mesh=self.mesh)
            spectra = spectra_dev.cpu().numpy()

        polarization = None
        if cfg.mode == 5:
            from .batch import polarization_batched
            T_avg = [cfg.T_switch if cfg.set_FO_temperature
                     else a.temperature for a in averages]
            with timer.phase("batched polarization"):
                pol = polarization_batched(stacked, species, grid, cfg,
                                           T_avg, mesh=self.mesh)
                polarization = {k: v.cpu().numpy() for k, v in pol.items()}

        decayed = None
        if cfg.do_resonance_decays:
            # each event's feed-down on the rank that owns it, the rows
            # gathered in event order
            from .kernels.decays import do_resonance_decays
            own = (range(len(loaded)) if layout is None
                   else range(*layout.owned()))
            with timer.phase("resonance decays"):
                rows = torch.stack([do_resonance_decays(
                    spectra_dev[e], particle_table, mcids, grid, cfg)
                    for e in own])
                if layout is not None:
                    rows = gather_events(rows, layout)
                decayed = rows.cpu().numpy()

        host_grid = grid.to("cpu")
        results = []
        for e in range(len(loaded)):
            res = RunResult(spectra=spectra[e], mcids=np.asarray(mcids),
                            averages=averages[e])
            event_dir = os.path.join(self.results_dir, f"event_{e}")
            if polarization is not None:
                res.polarization = {k: v[e] for k, v in polarization.items()}
            if write_files:
                writers.clean_results_dir(event_dir)
                with timer.phase("writers"):
                    self._write_smooth_files(spectra[e], host_grid, mcids,
                                             event_dir)
                    if polarization is not None:
                        p = res.polarization
                        writers.write_polarization(
                            p["St"], p["Sx"], p["Sy"], p["Sn"], p["Snorm"],
                            host_grid, cfg.dimension, event_dir)
            if decayed is not None:
                res.spectra = decayed[e]
                if write_files:
                    with timer.phase("decay writers"):
                        self._write_decay_files(res.spectra, host_grid,
                                                mcids, event_dir)
            results.append(res)
        return results

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

    def _write_decay_files(self, decayed, grid, mcids, results_dir):
        """The feed-down's files (reference: is3d_tpu/api.py:562-569)."""
        dim = self.cfg.dimension
        writers.write_dN_pTdpTdphidy(decayed, grid, mcids, dim, results_dir,
                                     suffix="_resonance_decays")
        writers.write_dN_dpTdphidy(decayed, grid, mcids, dim, results_dir,
                                   suffix="_resonance_decays")
