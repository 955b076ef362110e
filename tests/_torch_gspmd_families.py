"""Rank workers of the family-on-a-mesh tests
(tests/test_torch_gspmd_families.py, tests/test_torch_gspmd_serve.py,
tests/test_torch_cuda.py): the MoE, SSM and hybrid families (reduced, f32)
trained through ``make_train_step(..., mesh)``, prefilled through
``launch.serve.make_prefill_step(model, mesh)`` and decoded through
``make_serve_step(model, mesh)`` on DTensor params and caches, and the
same runs in one process (``mesh=None``) that they are held to; the dense
qwen2-0.5b decoded with its KV heads on 'model' and, where 'model' does
not divide them, with the cache's sequence dim there.

Every run starts from the seed's params with the constant-initialised
leaves (biases, norm scales, ``A_log`` / ``D`` / ``dt_bias``, the conv
bias, the LoRA ``b`` half) moved off their init, so each is exercised.

``launch.mesh.spawn_ranks`` pickles a worker by import path and runs it in
each rank as ``fn(mesh, *args)``. This module imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import sgd
from repro_torch.sharding.rules import distribute, param_specs
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

STEPS = 3
BATCH, SEQ = 4, 80          # 80: one whole 64-token SSD chunk and a padded one
PROMPT, NEW = 16, 8         # decode: a 16-token prompt, then 8 greedy tokens
DECODE_BATCH = 2
MAX_SEQ = PROMPT + NEW      # 24: 6 cache slots a rank on a 4-way sequence shard

MOE_AXES, DENSE_AXES = ("data", "expert", "tp"), ("data", "model")
#: family -> its mesh: the MoE on the reference's expert-parallel layout
#: (``make_moe_mesh``'s axes, every one of them 2), the SSM and the hybrid
#: on (data 2, model 2)
MESHES = {
    "qwen2-moe-a2.7b": ((2, 2, 2), MOE_AXES),
    "mixtral-8x7b": ((2, 2, 2), MOE_AXES),
    "mamba2-130m": ((2, 2), DENSE_AXES),
    "zamba2-1.2b": ((2, 2), DENSE_AXES),
}
FAMILIES = tuple(MESHES)
#: decode case -> (arch, mesh): the families on their meshes, and the dense
#: decoder with its 2 KV heads on 'model' (2-way) and, on a 4-way 'model'
#: that does not divide them, with its cache's sequence dim there
DECODE = {name: (name, mesh) for name, mesh in MESHES.items()}
DECODE.update({
    "qwen2-0.5b-kv-heads": ("qwen2-0.5b", ((2, 2), DENSE_AXES)),
    "qwen2-0.5b-seq": ("qwen2-0.5b", ((1, 4), DENSE_AXES)),
})

#: the leaves the reference initialises to constants (norm scales end in
#: "norm"; ``D`` starts at ones)
CONSTANT_INIT = ("bq", "bk", "bv", "conv_b", "dt_bias", "A_log", "D", "lora_b_q")


def _moved(params: dict, seed: int) -> dict:
    """The constant-initialised leaves plus 0.05·N(0, 1), drawn in path
    order from one generator: every rank moves them alike."""
    gen = torch.Generator().manual_seed(1000 + seed)

    def move(path, a):
        key = path[-1][1]
        if key in CONSTANT_INIT or str(key).endswith("norm"):
            noise = torch.randn(a.shape, generator=gen, dtype=torch.float32)
            return (a.float() + 0.05 * noise.to(a.device)).to(a.dtype)
        return a

    pairs, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [move(path, a) for path, a in pairs])


def model(arch: str, cfg_update: dict | None = None):
    """The reduced ``arch`` whose ``init`` gives the moved params."""
    cfg = dataclasses.replace(reduced(get_config(arch)), **(cfg_update or {}))
    m = build_model(cfg)
    init = m.init

    def moved_init(device="cuda", seed: int = 0):
        return _moved(init(device=device, seed=seed), seed)

    return dataclasses.replace(m, init=moved_init)


def sync_config() -> SyncConfig:
    """mpi_sgd, per-leaf (the mesh path is per-leaf, and so must the
    one-process oracle be)."""
    return SyncConfig(mode="mpi_sgd", fused_update=False, flat_exchange=False)


def batches(vocab: int) -> list:
    return [TokenPipeline(DataConfig(seed=0, vocab_size=min(vocab, 256), seq_len=SEQ,
                                     batch_size=BATCH), device="cpu").batch_at(0, i)
            for i in range(STEPS)]


def prompts(vocab: int) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, min(vocab, 256), (DECODE_BATCH, PROMPT)
                                         ).astype(np.int32))


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _gathered(mesh, tree):
    """``tree`` whole on this rank, on the host (under the mesh's staged
    collectives on the card)."""
    ctx = mesh.dtensor_collectives() if mesh is not None else contextlib.nullcontext()
    with ctx:
        return tree_map(lambda t: _full(t).cpu(), tree)


def train(mesh, arch: str, device="cpu", steps: int = STEPS) -> dict:
    """``steps`` momentum-SGD steps from the moved seed-0 params: on the
    DTensor state of ``mesh``, or in one process. Losses, every step's
    metrics (the MoE's aux term among them), and the whole state after
    the first step and after the last."""
    m = model(arch)
    opt, sync = sgd(0.1, 0.9), sync_config()
    state = T.make_train_state(m, opt, sync, 0, device=device, mesh=mesh)
    step = T.make_train_step(m, opt, sync, mesh, device=device)
    losses, metrics, first = [], [], None
    for b in batches(m.cfg.vocab_size)[:steps]:
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        metrics.append({k: float(v) for k, v in met.items()})
        if first is None:
            first = _gathered(mesh, state)
    return {"losses": losses, "metrics": metrics, "first": first,
            "state": _gathered(mesh, state)}


def prefill(mesh, arch: str, device="cpu") -> dict:
    """``model.forward`` over the first training batch's tokens through
    ``make_prefill_step``: the logits whole and, for the MoE, the
    (expert assignments, capacity, slot, keep) of every
    ``_dispatch_indices`` call as this rank computed them (its own batch
    rows, the first of them global row ``row0``)."""
    m = model(arch)
    dev = T.resolve_device(device)
    params = m.init(device=dev, seed=0)
    if mesh is not None:
        with mesh.dtensor_collectives():
            params = distribute(params, param_specs(params, mesh), mesh)
    step = S.make_prefill_step(m, mesh, device=device)
    seen = []
    orig = moe._dispatch_indices

    def recording(expert_idx, num_experts, capacity):
        slot, keep = orig(expert_idx, num_experts, capacity)
        seen.append((expert_idx.cpu(), capacity, slot.cpu(), keep.cpu()))
        return slot, keep

    moe._dispatch_indices = recording
    try:
        logits = step(params, {"tokens": batches(m.cfg.vocab_size)[0]["tokens"]})
    finally:
        moe._dispatch_indices = orig
    row0 = 0
    if mesh is not None:
        row0 = mesh.coords["data"] * (BATCH // mesh.shape["data"])
    return {"logits": _gathered(mesh, logits), "dispatch": seen, "row0": row0}


def decode(mesh, case: str, device="cpu", prompt: int = PROMPT,
           new: int = NEW) -> dict:
    """``prompt`` teacher-forced tokens, then ``new`` greedy ones, through
    ``make_serve_step`` (the params laid out once by ``param_specs``, the
    cache by the step): every step's logits, the greedy tokens, the final
    cache whole and, on a mesh, each cache leaf's placements."""
    arch = DECODE[case][0]
    m = model(arch)
    dev = T.resolve_device(device)
    params = m.init(device=dev, seed=0)
    if mesh is not None:
        with mesh.dtensor_collectives():
            params = distribute(params, param_specs(params, mesh), mesh)
    cache = m.init_cache(DECODE_BATCH, MAX_SEQ, dev)
    step = S.make_serve_step(m, mesh, device=device)
    toks = prompts(m.cfg.vocab_size).to(dev)
    logits, out = [], []
    for t in range(prompt):
        lg, cache = step(params, cache, toks[:, t:t + 1])
        logits.append(lg.cpu())
    for _ in range(new):
        tok = torch.argmax(logits[-1][:, -1], dim=-1).to(torch.int32)[:, None]
        out.append(tok)
        lg, cache = step(params, cache, tok.to(dev))
        logits.append(lg.cpu())
    layout = (None if mesh is None else
              tree_map(lambda t: tuple(str(p) for p in t.placements), cache))
    return {"logits": torch.stack(logits),
            "tokens": torch.cat(out, dim=1) if out else None,
            "cache": _gathered(mesh, cache), "layout": layout}


def card_case(mesh, device="cpu") -> dict:
    """The card test's case: the reduced qwen2-moe, one training step and
    one decode token."""
    return {"train": train(mesh, "qwen2-moe-a2.7b", device, steps=1),
            "decode": decode(mesh, "qwen2-moe-a2.7b", device, prompt=1, new=0)}


PATHS = {"train": train, "prefill": prefill, "decode": decode}


def rank(mesh, jobs, device="cpu") -> dict:
    """One rank of a mesh run: each ``(path, case)`` of ``jobs`` in turn."""
    return {(path, case): PATHS[path](mesh, case, device) for path, case in jobs}
