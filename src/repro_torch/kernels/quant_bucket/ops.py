"""Pytree form of the per-leaf QBLOCK codec: compress / decompress a tree
for a PS push (``repro/kernels/quant_bucket/ops.py``). Each leaf is
flattened and cast to f32, encoded by one ``quantize_flat`` launch, and
decoded by one ``dequantize_flat`` launch back into its shape and dtype."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.common import ceil_div
from repro_torch.kernels.quant_bucket.quant_bucket import (
    QBLOCK,
    dequantize_flat,
    quantize_flat,
)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def compress(tree: Any) -> tuple[Any, Any]:
    """tree -> (int8 codes tree, f32 scales tree)."""
    leaves, treedef = tree_flatten(tree)
    pairs = [quantize_flat(l.reshape(-1).float().contiguous()) for l in leaves]
    return (tree_unflatten(treedef, [c for c, _ in pairs]),
            tree_unflatten(treedef, [s for _, s in pairs]))


def decompress(codes: Any, scales: Any, like: Any) -> Any:
    """Inverse of ``compress``: each leaf back in ``like``'s shape and
    dtype (decoded in f32, then cast)."""
    return tree_map(
        lambda c, s, ref: dequantize_flat(c, s, ref.numel(), torch.float32)
        .reshape(ref.shape).to(ref.dtype),
        codes, scales, like)


def compressed_bytes(tree: Any) -> int:
    """Wire bytes of the compressed form: one int8 code per value and one
    f32 scale per QBLOCK block of each leaf."""
    return sum(l.numel() + ceil_div(l.numel(), QBLOCK) * 4
               for l in tree_leaves(tree))
