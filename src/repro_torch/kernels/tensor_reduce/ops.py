"""Shape-agnostic wrapper of the grouped-vector reduction
(``repro/kernels/tensor_reduce/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.tensor_reduce.tensor_reduce import group_reduce_flat


def group_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum a stacked group over its leading dim: ``(G, …) -> (…)``,
    through ``group_reduce_flat`` on the ``(G, N)`` view."""
    rest = tuple(x.shape[1:])
    return group_reduce_flat(x.reshape(x.shape[0], -1).contiguous()).reshape(rest)
