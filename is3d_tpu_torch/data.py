"""Per-species kernel inputs."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .tensors import TensorContainer


@dataclass(frozen=True)
class SpeciesArrays(TensorContainer):
    """Per-species kernel inputs, sliced from the host ParticleTable in
    chosen-particle order (reference: emissionfunction.cpp:1293-1307)."""

    mass: torch.Tensor        # (S,) GeV
    sign: torch.Tensor        # (S,) +1 fermion / -1 boson
    degeneracy: torch.Tensor  # (S,)
    baryon: torch.Tensor      # (S,)
    # densities at the surface-averaged state (sampler inputs; may be zeros)
    equilibrium_density: torch.Tensor
    bulk_density: torch.Tensor
    diff_density: torch.Tensor

    @property
    def n_species(self):
        return self.mass.shape[0]


def species_from_table(table, indices=None, dtype=torch.float64,
                       device="cpu") -> SpeciesArrays:
    idx = np.arange(len(table)) if indices is None else np.asarray(indices)
    pick = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)[idx],
                                     dtype=dtype, device=device)
    zeros = np.zeros(len(table))
    eq = table.equilibrium_density if table.equilibrium_density is not None else zeros
    bk = table.bulk_density if table.bulk_density is not None else zeros
    df = table.diff_density if table.diff_density is not None else zeros
    return SpeciesArrays(
        mass=pick(table.mass), sign=pick(table.sign),
        degeneracy=pick(table.gspin), baryon=pick(table.baryon),
        equilibrium_density=pick(eq), bulk_density=pick(bk),
        diff_density=pick(df),
    )
