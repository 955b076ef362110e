"""DTensor's collectives staged through host memory, for gloo ranks that
hold card tensors.

DTensor runs its collectives as ``torch.ops._c10d_functional`` ops (and
``_dtensor``'s own, such as the shard-to-shard all-to-all) on the local
tensors. gloo is a host transport, and several ranks on one card must use
it (NCCL refuses two). A probe on the H100 under torch 2.11 found DTensor's
all-gather, reduce-scatter and all-to-all over gloo on card tensors
crashing the rank; its all-reduce ran. So the GSPMD path stages every
collective as the process backend's ``collectives.Link`` stages its ring
hops: the inputs copied to pinned host memory, the same op run on the host
tensors over the same gloo group — same algorithm, same values — and the
outputs copied back to the card. ``StagedCollectives`` is the dispatch
mode that does so; the mesh step enters it when its ``Link`` is staged
(gloo with a card device: a property of the configuration, not of what
the run finds). The bytes and seconds land in the ``Link``'s ``stats``,
the bytes also by collective (``stats.by_op``: all-gather, reduce-scatter,
all-reduce, all-to-all, over whichever axis the op's group spans — the
model's tensor- and expert-parallel reshards and the MoE's expert
gather as much as the gradient sync).
"""
from __future__ import annotations

import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.collectives import Link
from repro_torch.tree import tree_leaves, tree_map

#: op namespaces whose ops are collectives
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
#: ops of those namespaces that move nothing
PASS_THROUGH = ("wait_tensor", "_wrap_tensor_autograd")


def staged_bytes(func, operand_bytes: int, result_bytes: int) -> int:
    """The bytes ``StagedCollectives`` stages for one collective op: every
    operand to the host, then the results back (an in-place op: its
    operands back into place)."""
    return operand_bytes + (operand_bytes if func._schema.is_mutable else result_bytes)


class StagedCollectives(TorchDispatchMode):
    """Within this mode, every collective op on card tensors runs on host
    copies through ``link`` (its ``stats`` count the staged bytes, the
    copies' seconds and the collective's), synchronously; waiting on its
    result is then a no-op. Ops on host tensors pass through untouched."""

    def __init__(self, link: Link):
        super().__init__()
        self.link = link

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # a mode runs before a tensor subclass: hand the op to DTensor
            # first, so the collectives it issues come back here on the
            # local tensors (the ones nested in it would bypass the mode)
            return NotImplemented
        kwargs = kwargs or {}
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        dev = self.link.device.type
        on_card = any(isinstance(t, torch.Tensor) and t.device.type == dev
                      for t in tree_leaves([list(args), kwargs]))
        if ns not in COLLECTIVE_NAMESPACES or not on_card:
            return func(*args, **kwargs)
        if name in PASS_THROUGH:
            # staged results are complete: there is no work to wait for
            return args[0] if name == "wait_tensor" else func(*args, **kwargs)
        stats = self.link.stats
        before = stats.d2h_bytes + stats.h2d_bytes
        try:
            return self._staged(func, args, kwargs, dev)
        finally:
            stats.by_op[name] = (stats.by_op.get(name, 0) + stats.d2h_bytes
                                 + stats.h2d_bytes - before)

    def _staged(self, func, args, kwargs, dev):
        host = lambda x: (self.link._to_host(x.contiguous())
                          if isinstance(x, torch.Tensor) else x)
        h_args, h_kwargs = tree_map(host, list(args)), tree_map(host, kwargs)
        t0 = time.perf_counter()
        out = func(*h_args, **h_kwargs)
        out = tree_map(lambda x: (torch.ops._c10d_functional.wait_tensor(x)
                                  if isinstance(x, torch.Tensor) else x), out)
        self.link.stats.p2p_s += time.perf_counter() - t0
        self.link.stats.messages += 1
        if func._schema.is_mutable:
            # in-place (``all_reduce_``): the result back into the inputs
            for a, h in zip(tree_leaves(list(args)), tree_leaves(h_args)):
                if isinstance(a, torch.Tensor) and a.device.type == dev:
                    a.copy_(self.link._to_device(h))
            return args[0]
        return tree_map(lambda x: (self.link._to_device(x)
                                   if isinstance(x, torch.Tensor) else x), out)
