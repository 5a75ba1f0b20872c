"""Typed run configuration.

Parses the reference's ``iS3D_parameters.dat`` format (``name = value  # comment``;
reference: src/cpp/ParameterReader.cpp) into a frozen, typed dataclass.  All
~45 parameters of the reference are covered with the same names and defaults
as ``is3d_tpu.config``, plus the port's own run knobs (precision, cell
chunking, the canonical reduction tree).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Config:
    # --- operation selection (reference: iS3D_parameters.dat) ---
    operation: int = 1          # 0: dN/dX spacetime, 1: smooth spectra, 2: sampler
    mode: int = 1               # freeze-out surface format (0-7)
    hrg_eos: int = 1            # 1: urqmd, 2: smash, 3: smash box
    set_FO_temperature: int = 0
    T_switch: float = 0.151     # GeV
    dimension: int = 2          # 2: boost-invariant (2+1)D, 3: (3+1)D
    df_mode: int = 1            # 1: 14-moment, 2: Chapman-Enskog, 3: Mike feqmod, 4: Jonah feqmod

    # --- df switches ---
    include_baryon: int = 0
    include_bulk_deltaf: int = 0
    include_shear_deltaf: int = 0
    include_baryondiff_deltaf: int = 0
    regulate_deltaf: int = 0
    outflow: int = 0

    # --- feqmod breakdown ---
    deta_min: float = 1.0e-5    # minimum detA before feqmod falls back to linear df
    mass_pion0: float = 0.138   # GeV, for the linearized pion-density breakdown test

    # --- particle grouping ---
    group_particles: int = 0
    particle_diff_tolerance: float = 0.01

    # --- resonance decays ---
    do_resonance_decays: int = 0
    lightest_particle: int = 111  # PDG MC id of lightest decay product

    # --- sampler ---
    oversample: int = 0
    min_num_hadrons: float = 1.0e7
    max_num_samples: int = 100
    fast: int = 0
    y_cut: float = 5.0
    sampler_seed: int = -1
    test_sampler: int = 0

    # --- sampler-test binning ---
    pT_lower_cut: float = 0.0
    pT_upper_cut: float = 3.0
    pT_bins: int = 100
    y_bins: int = 50
    eta_cut: float = 7.0
    eta_bins: int = 70
    tau_min: float = 0.0
    tau_max: float = 12.0
    tau_bins: int = 120
    r_min: float = 0.0
    r_max: float = 12.0
    r_bins: int = 60

    # --- reference compatibility quirks (no reference counterpart) ---
    # reproduce the reference's dN/dy and dN/dX momentum integrals, which
    # omit the pT Jacobian (write_dN_dy_toFile, calculate_dN_dX); default
    # is the physically correct integral
    reference_compat_dndy: int = 0
    # reproduce the reference SPECTRA kernel's 2+1D feqmod eta handling,
    # which skips the detA rescale for detA >= 1 and thereby drops the
    # 1/detA momentum-space jacobian on bulk-expanded cells
    # (emissionfunction_smooth_kernels.cpp:728 `detA < 1.0`).  Default is
    # the consistent, correct behavior
    reference_compat_feqmod_eta: int = 0

    # --- run knobs (no reference counterpart) ---
    precision: str = "f64"      # "f64" for parity runs, "f32" fast path
    cell_chunk: int = 65536     # cells per chunk of the plain spectra path
    cell_slab: int = 262144     # most cells one kernel launch takes; fixes
                                # canonical_groups together with reduce_groups
    reduce_groups: int = 8      # groups of the canonical cell-reduction
                                # tree (parallel/mesh.py): one kernel launch
                                # per group, partials folded in group order


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}
_INT_FIELDS = {
    f.name for f in dataclasses.fields(Config) if f.type in ("int", int)
}
_FLOAT_FIELDS = {
    f.name for f in dataclasses.fields(Config) if f.type in ("float", float)
}


def parse_parameter_text(text: str) -> dict:
    """Parse ``name = value # comment`` lines into a raw dict of strings.

    Mirrors the reference parser's tolerance (reference:
    src/cpp/ParameterReader.cpp: comments stripped at '#', blank lines and
    lines without '=' skipped).
    """
    out = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        name, value = line.split("=", 1)
        name = name.strip()
        value = value.strip()
        if name and value:
            out[name] = value
    return out


def _coerce(name: str, raw: str):
    if name in _INT_FIELDS:
        # the reference stores everything as double; ints like 1.0e+8 appear
        return int(float(raw))
    if name in _FLOAT_FIELDS:
        return float(raw)
    return raw


def load_config(path: Optional[str] = None, text: Optional[str] = None,
                overrides: Optional[dict] = None, strict: bool = False) -> Config:
    """Build a Config from an iS3D_parameters.dat-style file and/or overrides.

    Unknown keys are ignored unless ``strict`` (the reference accepts any key;
    we only type-check the ones we model).  ``overrides`` (e.g. from CLI
    ``key=value`` arguments, reference: src/cpp/ParameterReader.cpp:102) win
    over file values.
    """
    raw = {}
    if path is not None:
        with open(path) as f:
            raw.update(parse_parameter_text(f.read()))
    if text is not None:
        raw.update(parse_parameter_text(text))
    if overrides:
        raw.update({k: str(v) for k, v in overrides.items()})

    kwargs = {}
    for name, value in raw.items():
        if name not in _FIELD_TYPES:
            if strict:
                raise KeyError(f"unknown parameter: {name}")
            continue
        kwargs[name] = _coerce(name, value)
    return Config(**kwargs)
