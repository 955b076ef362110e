"""Per-leaf form of the one-pair elastic exchange
(``repro/kernels/fused_elastic/ops.py``): one ``elastic_exchange_flat``
launch per leaf. The packed single-launch form is
``core.elastic.elastic_exchange_packed``."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.fused_elastic.fused_elastic import elastic_exchange_flat
from repro_torch.tree import tree_flatten, tree_unflatten


def elastic_exchange_fused(params: Any, center: Any,
                           alpha: torch.Tensor) -> tuple[Any, Any]:
    """Eqs. (2)+(3) leaf by leaf, one fused pass per leaf; ``alpha`` is
    one f32 value on the leaves' device."""
    w_leaves, treedef = tree_flatten(params)
    c_leaves, c_def = tree_flatten(center)
    if c_def != treedef:
        raise ValueError(f"tree structures differ: {treedef} vs {c_def}")
    pairs = [elastic_exchange_flat(w.reshape(-1), c.reshape(-1), alpha)
             for w, c in zip(w_leaves, c_leaves)]
    return (tree_unflatten(treedef, [nw.reshape(w.shape)
                                     for (nw, _), w in zip(pairs, w_leaves)]),
            tree_unflatten(treedef, [nc.reshape(c.shape)
                                     for (_, nc), c in zip(pairs, c_leaves)]))
