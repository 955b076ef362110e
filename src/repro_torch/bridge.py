"""Carry weights between the reference package and the port as numpy.

``params_from_numpy`` takes a parameter tree of numpy arrays — the
reference's nested keys and stacked ``(L, …)`` leaves, e.g. from
``jax.tree.map(np.asarray, params)`` — and returns the port's params;
``params_to_numpy`` is its inverse. bf16 arrays (numpy's bfloat16, which
the reference's ``ml_dtypes`` registers) cross bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, order="C").view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy's bfloat16 is the one ml_dtypes registers, which the
        # reference loads: the port itself never imports it
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            raise RuntimeError("numpy has no bfloat16 dtype: import the "
                               "reference (its ml_dtypes registers one) "
                               "before bridging a bf16 tree") from None
        return t.view(torch.uint16).numpy().view(bf16)
    return t.numpy().copy()


def params_from_numpy(tree: Any, device="cpu") -> Any:
    return tree_map(lambda a: _from_numpy(a, device), tree)


def params_to_numpy(params: Any) -> Any:
    return tree_map(_to_numpy, params)
