"""Base class of the port's state containers.

The JAX package keeps its state in ``flax.struct`` pytrees; here each
container is a frozen ``@dataclass`` of tensors that moves as a whole with
``.to(device, dtype)``.  Integer, boolean and non-tensor fields keep their
type: only floating tensors take ``dtype``.
"""

from __future__ import annotations

import dataclasses

import torch


def _convert(value, device, dtype):
    if isinstance(value, torch.Tensor):
        return value.to(device=device,
                        dtype=dtype if value.is_floating_point() else None)
    if isinstance(value, TensorContainer):
        return value.to(device, dtype)
    if isinstance(value, dict):
        return {k: _convert(v, device, dtype) for k, v in value.items()}
    return value


class TensorContainer:
    """Mixin for frozen dataclasses whose fields are tensors, nested
    containers, dicts of either, or plain Python values."""

    def to(self, device=None, dtype=None):
        return dataclasses.replace(self, **{
            f.name: _convert(getattr(self, f.name), device, dtype)
            for f in dataclasses.fields(self)})
