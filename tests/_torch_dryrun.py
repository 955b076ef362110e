"""Fake-world jobs of tests/test_torch_dryrun.py, each run as its own
process (a "fake" world is joined once a process):

  PYTHONPATH=src python tests/_torch_dryrun.py <job>

prints one JSON line. Jobs:

- ``shapes256`` / ``shapes512``: the local ``meta`` shard shape of every
  leaf of the dry run's train state (``train_4k``) and decode cache
  (``decode_32k``) for all ten architectures, on the production pod and
  the MoE pod (256 ranks) or on the multi-pod layout (512, mpi_esgd with
  a client a pod);
- ``extrap256``: the full-depth trace and ``dryrun.extrapolation``'s
  values of a dense decoder and of the hybrid, on the pod, at a short
  training shape;
- ``world4``: on a world of 4, the staged bytes by collective of the
  prefills that chip_smoke's phase 15 c) measures (each case's config,
  depth, dtype, batch and mesh), and one dense layer's traced FLOPs.

This module imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import torch

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, InputShape, get_config
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import _mesh_over_world, join_trace_world, make_moe_mesh, make_production_mesh
from repro_torch.tree import tree_flatten_with_path

#: chip_smoke's phase 15 c) cases: (arch, depth, (data, model), (batch, sequence))
PREFILL_CASES = {
    "whisper-base": (6, (2, 2), (4, 448)),
    "paligemma-3b": (2, (2, 2), (4, 512)),
    "qwen2.5-3b": (2, (2, 2), (4, 512)),
    "qwen3-4b": (2, (2, 2), (4, 512)),
    "phi3-medium-14b": (2, (1, 4), (4, 512)),
}
#: (e): the architectures and the depth each is traced at in full (the
#: hybrid at three whole groups of its period), at a short training shape
EXTRAP_CASES = {"qwen2-0.5b": 24, "zamba2-1.2b": 18}
EXTRAP_SHAPE = InputShape("train_256", 256, 16, "train")
#: (f): the dense layer whose FLOPs are held to the closed form
LAYER_CASE = ("qwen2.5-3b", (2, 2), (4, 512))


def _local_shapes(tree) -> dict:
    """{key path: this rank's shard shape} of a DTensor tree."""
    pairs, _ = tree_flatten_with_path(tree)
    return {"/".join(str(k) for _, k in path): list(t.to_local().shape)
            for path, t in pairs}


def _shapes(mesh, mode: str) -> dict:
    C = mesh.shape.get("pod", 1) if mode == "mpi_esgd" else 1
    sync = SyncConfig(mode=mode, num_clients=C)
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        _, (state, _) = D.step_and_args(cfg, INPUT_SHAPES["train_4k"], mesh, sync)
        _, (_, cache, _) = D.step_and_args(cfg, INPUT_SHAPES["decode_32k"], mesh, sync)
        out[arch] = {"state": _local_shapes(state), "cache": _local_shapes(cache)}
    return out


def shapes256() -> dict:
    join_trace_world(256)
    return {"pod": _shapes(make_production_mesh(device="meta"), "mpi_sgd"),
            "moe": _shapes(make_moe_mesh(device="meta"), "mpi_sgd")}


def shapes512() -> dict:
    join_trace_world(512)
    return {"multipod": _shapes(make_production_mesh(multi_pod=True, device="meta"),
                                "mpi_esgd")}


def extrap256() -> dict:
    join_trace_world(256)
    mesh = make_production_mesh(device="meta")
    sync = SyncConfig(mode="mpi_sgd")
    out = {}
    for arch, depth in EXTRAP_CASES.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        full = D._trace_metrics(D.lower_module(cfg, EXTRAP_SHAPE, mesh, sync))
        extra = D.extrapolation(cfg, EXTRAP_SHAPE, mesh, sync)
        out[arch] = {"full": {k: full[k] for k in ("flops", "bytes", "wire")},
                     "extrapolation": extra}
    return out


def _case_cfg(arch: str, depth: int):
    return dataclasses.replace(get_config(arch), num_layers=depth, dtype="bfloat16")


def world4() -> dict:
    join_trace_world(4)
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = _mesh_over_world(shape, ("data", "model"), "meta", "world4")
        return meshes[shape]

    sync = SyncConfig(mode="mpi_sgd")
    prefill = {}
    for arch, (depth, shape, (B, S)) in PREFILL_CASES.items():
        tr = D.lower_module(_case_cfg(arch, depth), InputShape("prefill", S, B, "prefill"),
                            mesh_of(shape), sync)
        prefill[arch] = tr.recorder.staged_by_op()
    arch, shape, (B, S) = LAYER_CASE
    flops = [D.lower_module(_case_cfg(arch, L), InputShape("prefill", S, B, "prefill"),
                            mesh_of(shape), sync).recorder.flops for L in (1, 2)]
    return {"prefill": prefill, "layer_flops": flops[1] - flops[0]}


JOBS = {f.__name__: f for f in (shapes256, shapes512, extrap256, world4)}

if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps(JOBS[sys.argv[1]]()), flush=True)
