"""Rank workers of the family-on-a-mesh tests
(tests/test_torch_gspmd_families.py, tests/test_torch_gspmd_serve.py,
tests/test_torch_gspmd_encdec_vlm.py, tests/test_torch_gspmd_dense.py,
tests/test_torch_cuda.py): the MoE, SSM and hybrid families, the
encoder-decoder (whisper), the VLM (paligemma) and the dense decoders
(reduced, f32) trained through ``make_train_step(..., mesh)``, prefilled
through ``launch.serve.make_prefill_step(model, mesh)`` and decoded
through ``make_serve_step(model, mesh)`` on DTensor params and caches,
and the same runs in one process (``mesh=None``) that they are held to;
the dense qwen2-0.5b decoded with its KV heads on 'model' and, where
'model' does not divide them, with the cache's sequence dim there.

A case names an arch (``arch_of``) and the mesh it runs on: the arch's
own name for the families of ``MESHES`` / ``ENCDEC_VLM`` / ``DENSE``, a
suffixed one (``qwen2.5-3b-seq``) for a second layout. Batches carry
every key of the arch's ``input_specs`` (``batches_for``): the stub
audio frames and image embeddings N(0, 1) from a seeded numpy generator,
the VLM's text the sequence less its image prefix.

Every run starts from the seed's params with the constant-initialised
leaves (biases, norm scales, ``A_log`` / ``D`` / ``dt_bias``, the conv
bias, the LoRA ``b`` half) moved off their init, so each is exercised.

``launch.mesh.spawn_ranks`` pickles a worker by import path and runs it in
each rank as ``fn(mesh, *args)``. This module imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types

import numpy as np
import torch

from repro_torch.configs.base import InputShape, get_config, reduced
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import sgd
from repro_torch.sharding.rules import distribute, is_spec, param_specs
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten

RTOL = 1e-5                 # every hold of a mesh run against one process
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

#: the encoder-decoder, the VLM and the dense decoders, each on (data 2,
#: model 2), and qwen2.5-3b also on (data 1, model 4): a 4-way 'model'
#: over its 2 KV heads cuts the ``bk`` / ``bv`` columns inside a head and
#: shards the cache's sequence dim
ENCDEC_VLM = {name: (name, ((2, 2), DENSE_AXES))
              for name in ("whisper-base", "paligemma-3b")}
DENSE = {name: (name, ((2, 2), DENSE_AXES))
         for name in ("qwen2.5-3b", "qwen3-4b", "phi3-medium-14b")}
DENSE["qwen2.5-3b-seq"] = ("qwen2.5-3b", ((1, 4), DENSE_AXES))
CASES = {**{n: (n, m) for n, m in MESHES.items()}, **DECODE, **ENCDEC_VLM, **DENSE}


def arch_of(case: str) -> str:
    """The arch a case runs (a family's own name names itself)."""
    return CASES[case][0] if case in CASES else case


#: the leaves the reference initialises to constants (norm scales end in
#: "norm", whisper's LayerNorm biases in "norm_b"; ``D`` starts at ones)
CONSTANT_INIT = ("bq", "bk", "bv", "conv_b", "dt_bias", "A_log", "D", "lora_b_q")


def _moved(params: dict, seed: int) -> dict:
    """The constant-initialised leaves plus 0.05·N(0, 1), drawn in path
    order from one generator: every rank moves them alike."""
    gen = torch.Generator().manual_seed(1000 + seed)

    def move(path, a):
        key = path[-1][1]
        if key in CONSTANT_INIT or str(key).endswith(("norm", "norm_b")):
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


def batches(vocab: int, batch: int = BATCH, seq: int = SEQ,
            steps: int = STEPS) -> list:
    return [TokenPipeline(DataConfig(seed=0, vocab_size=min(vocab, 256), seq_len=seq,
                                     batch_size=batch), device="cpu").batch_at(0, i)
            for i in range(steps)]


def batches_for(m, batch: int = BATCH, seq: int = SEQ, steps: int = STEPS) -> list:
    """``steps`` training batches of every key of ``m.input_specs`` for a
    (``batch``, ``seq``) train shape: tokens and labels from the token
    pipeline over the text (the sequence less the VLM's image prefix),
    the stub audio frames / image embeddings N(0, 1) from a numpy
    generator seeded by the step, in the model's dtype. For a decoder
    without such leaves, ``batches``."""
    specs = m.input_specs(InputShape("train", seq, batch, "train"))
    out = batches(m.cfg.vocab_size, batch, specs["tokens"].shape[1], steps)
    for i, b in enumerate(out):
        rng = np.random.default_rng(100 + i)
        for k, v in specs.items():
            if k not in b:
                b[k] = torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
                    np.float32)).to(v.dtype)
    return out


def enc_output(m, batch: int) -> torch.Tensor:
    """A nonzero stand-in for the encoder output of whisper's serve cache
    (``init_cache`` makes zeros and nothing fills them, as in the
    reference): N(0, 1) from a seeded numpy generator."""
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.standard_normal(
        (batch, m.cfg.enc_seq_len, m.cfg.d_model)).astype(np.float32)).to(m.cfg.torch_dtype)


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


def train(mesh, case: str, device="cpu", steps: int = STEPS) -> dict:
    """``steps`` momentum-SGD steps from the moved seed-0 params: on the
    DTensor state of ``mesh``, or in one process. Losses, every step's
    metrics (the MoE's aux term among them), and the whole state after
    the first step and after the last."""
    m = model(arch_of(case))
    opt, sync = sgd(0.1, 0.9), sync_config()
    state = T.make_train_state(m, opt, sync, 0, device=device, mesh=mesh)
    step = T.make_train_step(m, opt, sync, mesh, device=device)
    losses, metrics, first = [], [], None
    for b in batches_for(m)[:steps]:
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        metrics.append({k: float(v) for k, v in met.items()})
        if first is None:
            first = _gathered(mesh, state)
    return {"losses": losses, "metrics": metrics, "first": first,
            "state": _gathered(mesh, state)}


def prefill(mesh, case: str, device="cpu") -> dict:
    """``model.forward`` over the first training batch (its labels left
    out) through ``make_prefill_step``: the logits whole and, for the
    MoE, the
    (expert assignments, capacity, slot, keep) of every
    ``_dispatch_indices`` call as this rank computed them (its own batch
    rows, the first of them global row ``row0``)."""
    m = model(arch_of(case))
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
        logits = step(params, {k: v for k, v in batches_for(m)[0].items()
                               if k != "labels"})
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
    cache whole and, on a mesh, each cache leaf's placements. Whisper's
    cache holds ``enc_output`` as its encoder output."""
    m = model(arch_of(case))
    dev = T.resolve_device(device)
    params = m.init(device=dev, seed=0)
    if mesh is not None:
        with mesh.dtensor_collectives():
            params = distribute(params, param_specs(params, mesh), mesh)
    cache = m.init_cache(DECODE_BATCH, MAX_SEQ, dev)
    if "enc" in cache:
        cache["enc"].copy_(enc_output(m, DECODE_BATCH))
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


def card_case(mesh, device="cpu", case: str = "qwen2-moe-a2.7b") -> dict:
    """A card test's case (the reduced qwen2-moe, or whisper-base): one
    training step and one decode token."""
    return {"train": train(mesh, case, device, steps=1),
            "decode": decode(mesh, case, device, prompt=1, new=0)}


PATHS = {"train": train, "prefill": prefill, "decode": decode}


def world_runs(jobs, world: int = 4, device="cpu", meanwhile=None) -> tuple:
    """``jobs`` on ``world`` gloo ranks (``world_rank``, one spawn, in a
    thread) and meanwhile, in this process on one BLAS thread, each job
    in one process (once for the cases of one arch) and then
    ``meanwhile()``: ({job: [rank results]}, {job: one-process result},
    what ``meanwhile`` returned)."""
    import threading

    from repro_torch.launch.mesh import spawn_ranks

    res, errors = [], []

    def run():
        try:
            res.extend(spawn_ranks(world_rank, (world,), ("world",), backend="gloo",
                                   device=device, args=(jobs,)))
        except Exception as e:  # re-raised below, in the caller's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    torch.set_num_threads(1)
    try:
        by_arch = {}
        for path, case in jobs:
            key = (path, arch_of(case))
            if key not in by_arch:
                by_arch[key] = PATHS[path](None, case, device)
        one = {(path, case): by_arch[(path, arch_of(case))] for path, case in jobs}
        extra = meanwhile() if meanwhile is not None else None
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return {job: [r[job] for r in res] for job in jobs}, one, extra


def close(a, b, rtol: float = RTOL) -> None:
    """``a`` within ``rtol`` of ``b`` and of b's scale (max |b|)."""
    a, b = a.float().numpy(), b.float().numpy()
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def close_trees(got, want, rtol: float = RTOL) -> None:
    """Same paths, shapes and dtypes; int leaves equal, the rest
    ``close``."""
    gl, wl = tree_flatten_with_path(got)[0], tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if not b.is_floating_point():
            assert torch.equal(a, b), path
        else:
            close(a, b, rtol)


def hold(path: str, got: dict, want: dict, rtol: float = RTOL) -> None:
    """One rank's ``path`` run against the one-process run: training
    losses, every metric and the state after the first and the last step;
    prefill logits; every decode step's logits, the greedy tokens and the
    final cache."""
    if path == "train":
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
        for gm, wm in zip(got["metrics"], want["metrics"]):
            assert set(gm) == set(wm)
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], rtol=rtol, err_msg=k)
        close_trees(got["first"], want["first"], rtol)
        close_trees(got["state"], want["state"], rtol)
    elif path == "prefill":
        close(got["logits"], want["logits"], rtol)
    else:
        assert got["logits"].shape == want["logits"].shape
        for t in range(want["logits"].shape[0]):
            close(got["logits"][t], want["logits"][t], rtol)
        assert torch.equal(got["tokens"], want["tokens"])
        close_trees(got["cache"], want["cache"], rtol)


def world_rank(world, jobs, device="cpu", meshes: dict | None = None,
               paths: dict | None = None) -> dict:
    """One rank of a world whose ``(path, case)`` jobs each run on the
    case's own layout of it (``CASES``): one process start for cases on
    different meshes. ``meshes``, when given, collects the layouts built
    (layout -> ``Mesh``); ``paths`` replaces ``PATHS``."""
    from repro_torch.launch.mesh import _mesh_over_world

    meshes = {} if meshes is None else meshes
    paths = PATHS if paths is None else paths
    out = {}
    for path, case in jobs:
        layout = CASES[case][1]
        if layout not in meshes:
            meshes[layout] = _mesh_over_world(*layout, world.device, "world_rank")
        out[(path, case)] = paths[path](meshes[layout], case, device)
    return out


def rank(mesh, jobs, device="cpu") -> dict:
    """One rank of a mesh run: each ``(path, case)`` of ``jobs`` in turn."""
    return {(path, case): PATHS[path](mesh, case, device) for path, case in jobs}


def staged_prediction(name: str, depth: int, shape: tuple, train=None,
                      prefill=None, batch: int = 4, dtype_bytes: int = 2,
                      prefill_tail: int = 8) -> dict:
    """A reckoning, before any run, of the bytes one rank of a full-width
    (``name`` at ``depth`` layers) case on ('data', 'model') = ``shape``
    stages through host memory, by collective: a training step of
    ``train`` = (batch, sequence), a prefill of ``prefill`` and a decode
    token at ``batch`` rows. Staged bytes count both copies, so an
    all-reduce of n local bytes stages 2n and an all-gather of n local
    bytes from N ranks n + N·n. From ``param_specs`` over ``meta`` params
    (each gradient all-reduced over 'data', and over 'model' too where the
    leaf is replicated there) and the activations' shapes:

    - a block (attention, cross-attention, FFN) whose output rows are
      sharded over 'model' all-reduces its (B/data, S, d) output in the
      forward, again in the remat recompute, and its input gradient in
      the backward;
    - the vocab-parallel lookup all-reduces its rows; the loss gathers the
      logits over the vocab and all-reduces their gradient into h;
    - KV heads that 'model' does not divide gather k / v (and, in the
      full-sequence core, q) over the heads;
    - whisper's cross-attention gathers the encoder output's d (on
      'model' in the decode cache) for its k and v products each token,
      and in training all-reduces the gradient into the encoder output
      once;
    - a decode step's logits are gathered whole; ``prefill_tail``
      positions of a prefill's likewise.

    Not measured: a reckoning to set beside the chip run's
    ``LinkStats.by_op``."""
    cfg = dataclasses.replace(get_config(name), num_layers=depth)
    data, mdl = shape
    e = dtype_bytes
    d, hd = cfg.d_model, cfg.resolved_head_dim
    V = cfg.padded_vocab
    kv_split = cfg.num_kv_heads % mdl != 0

    meta = build_model(cfg).init(device="meta")
    specs = param_specs(meta, types.SimpleNamespace(shape={"data": data, "model": mdl}))
    leaves = list(zip(tree_leaves(meta), tree_leaves(specs, is_spec)))
    local = [leaf.numel() * e // (mdl if "model" in spec else 1) for leaf, spec in leaves]
    grad_ar = sum(2 * n * ((data > 1) + ("model" not in spec and mdl > 1))
                  for n, (_, spec) in zip(local, leaves))

    def blocks(S, n_blocks, passes):
        return 2 * (batch_rows * S * d * e) * n_blocks * passes

    out = {}
    if train:
        B, S = train
        batch_rows = B // data
        text = S - cfg.num_image_tokens
        ar = grad_ar
        ag = 0
        if cfg.is_enc_dec:
            F_ = cfg.enc_seq_len
            ar += blocks(F_, 2 * cfg.enc_layers, 3) + blocks(S, 3 * depth, 3)
            ar += 2 * batch_rows * F_ * d * e               # grad into the encoder output
        else:
            ar += blocks(S, 2 * depth, 3)
        ar += 2 * batch_rows * text * d * e * 2              # lookup rows, grad into h
        logits_local = batch_rows * text * (V // mdl) * e
        ag += logits_local * (1 + mdl)
        if kv_split:
            kv_local = batch_rows * S * cfg.num_kv_heads * hd // mdl * e
            q_local = batch_rows * S * cfg.num_heads * hd // mdl * e
            ag += (2 * kv_local + q_local) * (1 + mdl) * depth * 2
        out["step"] = {"all_reduce": ar, "all_gather_into_tensor": ag}
    if prefill:
        B, S = prefill
        batch_rows = B // data
        ar = 2 * batch_rows * (S - cfg.num_image_tokens) * d * e   # lookup rows
        ag = 0
        if cfg.is_enc_dec:
            ar += blocks(cfg.enc_seq_len, 2 * cfg.enc_layers, 1) + blocks(S, 3 * depth, 1)
        else:
            ar += blocks(S, 2 * depth, 1)
        if kv_split:
            kv_local = batch_rows * S * cfg.num_kv_heads * hd // mdl * e
            q_local = batch_rows * S * cfg.num_heads * hd // mdl * e
            ag += (2 * kv_local + q_local) * (1 + mdl) * depth
        tail_local = batch_rows * prefill_tail * (V // mdl) * e
        ag += tail_local * (1 + data * mdl)
        out["prefill"] = {"all_reduce": ar, "all_gather_into_tensor": ag}
    batch_rows = batch // data
    ar = 2 * batch_rows * d * e                              # lookup rows
    ag = batch_rows * (V // mdl) * e * (1 + data * mdl)      # the logits whole
    n_blocks = 3 if cfg.is_enc_dec else 2
    ar += 2 * batch_rows * d * e * n_blocks * depth
    if cfg.is_enc_dec:
        enc_local = batch_rows * cfg.enc_seq_len * d // mdl * e
        ag += 2 * enc_local * (1 + mdl) * depth
    if kv_split:
        ag += (2 * cfg.num_kv_heads + cfg.num_heads) * hd * batch_rows * e * depth
    out["token"] = {"all_reduce": ar, "all_gather_into_tensor": ag}
    out["params_local_bytes"] = sum(local)
    out["params"] = sum(leaf.numel() for leaf, _ in leaves)
    return out


if __name__ == "__main__":
    # PYTHONPATH=src python tests/_torch_gspmd_families.py: the staged-bytes
    # reckoning of chip_smoke's [gspmd:families] c) cases
    for args in (("whisper-base", 6, (2, 2), (4, 448), (4, 448)),
                 ("paligemma-3b", 2, (2, 2), (4, 512), (4, 512)),
                 ("qwen2.5-3b", 2, (2, 2), None, (4, 512)),
                 ("qwen3-4b", 2, (2, 2), None, (4, 512)),
                 ("phi3-medium-14b", 2, (1, 4), None, (4, 512))):
        print(args[0], args[1:], staged_prediction(*args))
