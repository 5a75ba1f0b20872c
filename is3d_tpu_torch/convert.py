"""Build the port's state from the JAX package's state.

Each function takes one of ``is3d_tpu``'s state containers as a plain dict
of numpy arrays keyed by field name (nested dicts for nested containers:
the DeltafData splines, the tables) and returns the port's dataclass on the
given device and dtype.  The dicts are made on the JAX side with
``np.asarray`` per field, so both packages compute on identical inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .data import SpeciesArrays
from .io.deltaf import DeltafData
from .io.surface import Surface, ThermoAverages, surface_from_arrays
from .io.tables import MomentumGrid
from .physics.splines import CubicSpline


def _t(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                        device=device)


def surface_from_state(state: dict, device="cpu", dtype=torch.float64,
                       requires_grad=()) -> Surface:
    """Every surface column, those of the VAH (Lambda, aL, aT, c0..c4, W,
    pi_perp) and vorticity (w) blocks too; absent (None) ones stay None.
    The columns named in ``requires_grad`` are leaves that require grad."""
    surface = surface_from_arrays(dtype=dtype, device=device,
                                  **{k: v for k, v in state.items()
                                     if v is not None})
    return surface.replace(**{k: getattr(surface, k).requires_grad_(True)
                              for k in requires_grad})


def grads_from_state(grads: dict, device="cpu",
                     dtype=torch.float64) -> dict:
    """A JAX gradient dict (is3d_tpu.diff.surface_value_and_grad's, numpy
    per field) as tensors keyed by the port's Surface field names (the
    same names: the two Surfaces share their fields)."""
    fields = {f.name for f in dataclasses.fields(Surface)}
    unknown = set(grads) - fields
    if unknown:
        raise ValueError(f"not Surface fields: {sorted(unknown)}")
    return {k: _t(v, device, dtype) for k, v in grads.items()}


def averages_from_state(state: dict) -> ThermoAverages:
    """The surface averages (the run's plasma: T_avg and the rest) from
    the JAX package's ThermoAverages fields."""
    return ThermoAverages(**{k: float(v) for k, v in state.items()})


def species_from_state(state: dict, device="cpu",
                       dtype=torch.float64) -> SpeciesArrays:
    return SpeciesArrays(**{k: _t(v, device, dtype) for k, v in state.items()})


def grid_from_state(state: dict, device="cpu",
                    dtype=torch.float64) -> MomentumGrid:
    fields = {k: _t(v, device, dtype) for k, v in state.items()
              if k != "eta_mT_rescale"}
    return MomentumGrid(**fields,
                        eta_mT_rescale=bool(state.get("eta_mT_rescale", False)))


def spline_from_state(state: Optional[dict], device="cpu",
                      dtype=torch.float64) -> Optional[CubicSpline]:
    if state is None:
        return None
    return CubicSpline(**{k: _t(state[k], device, dtype)
                          for k in ("x", "y", "b", "c", "d")})


def deltaf_from_state(state: dict, device="cpu",
                      dtype=torch.float64) -> DeltafData:
    return DeltafData(
        T_grid=_t(state["T_grid"], device, dtype),
        muB_grid=_t(state["muB_grid"], device, dtype),
        tables={k: _t(v, device, dtype) for k, v in state["tables"].items()},
        splines={k: spline_from_state(v, device, dtype)
                 for k, v in state["splines"].items()},
        lambda2_spline=spline_from_state(state.get("lambda2_spline"), device,
                                         dtype),
        z_spline=spline_from_state(state.get("z_spline"), device, dtype),
        bulkPi_over_Peq_max=_t(state["bulkPi_over_Peq_max"], device, dtype),
    )
