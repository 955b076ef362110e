#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on past its own):

  1. device   require CUDA, print the card's name and power limit, TF32 off;
              build the CUDA C++ libraries from src/repro_torch/csrc (nvcc
              for sm_90a into build/cuda/) and print ptxas's registers,
              shared memory and spills for every kernel instantiation
  2. kernels  build each Triton kernel of the paths from this checkout
              (cache in build/), run every kernel at the shape its path
              gives it (the full-width qwen2-0.5b buffers, n = 494,147,584
              per device) and hold it against its plain PyTorch version on
              the same tensors; time kernel, plain version and, where one
              exists, a one-call PyTorch yardstick the port never calls —
              kernel and yardstick in turns (7 rounds of library x10,
              kernel x10, kernel x10, library x10; median and min–max)
  3. slice    a) the reduced model, 3 steps per optimizer on the card
                 against the same steps on the CPU (a small reference)
              b) full-width qwen2-0.5b in bf16, batch 8 x seq 512, through
                 make_train_state -> make_train_step -> FlatEngine, a few
                 mpi-SGD steps each for sgd, adamw and adagrad, with the
                 kernels' launch counts set to 0 just before and read just
                 after; step time, its breakdown, and peak memory
  4. ckpt     npz checkpoint round trip of the trained params
  5. esgd     slice 2, mpi-ESGD and mpi-SGD across emulated devices:
              a) the reduced model, 3 steps of the (2, 2) shard driver
                 (mpi_esgd, int8 wire) and of the C = 2 multi-client step,
                 card against CPU
              b) full-width qwen2-0.5b in bf16, 6 momentum-SGD steps per
                 run, each run's launch counts set to 0 just before it and
                 read just after: the C = 2 multi-client train step; the
                 (2, 2) shard driver (mpi_esgd, f32 wire, then int8); the
                 p = 4 shard driver (mpi_sgd, int8 wire); step time, its
                 split, peak memory, and the wire bytes the emulated hops
                 counted against the cost model; after each run, the SGD
                 kernel on that run's stacked param / momentum / grad
                 shards held against its plain version
  6. ps       slice 3, the in-process PS tier (KVStore + algorithms.run):
              a) the reduced model, all six modes (and mpi-/dist-ESGD over
                 the int8 wire) on the card against the CPU: the simulated
                 clock equal, losses and eval metrics within rtol 1e-4
              b) full-width qwen2-0.5b in bf16, mpi-ESGD with 4 workers in
                 2 clients, 2 x 512 tokens per worker, 4 iterations per
                 client (8 completions, 4 exchanges), over the int8 PS wire
                 and then the f32 one: launch counts, finite losses, the
                 center's eval loss below its start, PS wire bytes against
                 the cost model, the four PS-tier kernels held against
                 their plain versions on the run's last exchange operands,
                 a completion's split, peak memory and device-busy share

  7. faults   slice 4, fault injection and elastic membership:
              a) [faults:small] the reduced model through algorithms.run
                 on the card against the CPU under the reference's fault
                 schedules (mpi_sgd and dist_sgd: a kill and a straggler
                 with a barrier timeout; mpi_asgd: a kill and a lost
                 push; mpi_esgd over the per-leaf int8 codec: a kill and a
                 straggler), the clock and the robustness counters equal;
                 then drive(p=4) under a kill and a rejoin, card == CPU
              b) [faults] full-width qwen2-0.5b in bf16: (i) mpi-ESGD
                 through algorithms.run over the per-leaf int8 PS wire
                 (flat_exchange=False) under a straggle, a retried drop
                 and a kill; (ii) a list push of two full-width bf16 grad
                 trees; (iii) elastic_exchange_packed at f32 and over the
                 int8 wire; (iv) the p = 4 mpi-SGD shard driver under a
                 kill and a rejoin — launch counts, byte counts and the
                 membership outcomes checked, times and peak memory

Phase 2 also holds and times the PS tier's four kernels (quantize_wire,
dequantize_wire, elastic_client_flat, elastic_server_flat) at the packed
full-width buffer, n = 494,147,584, and slice 4's four (group_reduce_flat
and the QBLOCK codec over the whole 14-leaf tree, elastic_exchange_flat
on the packed buffer). The two dequantizers are timed in turns with
their one-call yardstick, ``torch.mul(codes.view(nb, B), scales.view(nb,
1))``, held equal to the plain version first. The CUDA C++
elastic_center_flat is held ``==`` its plain version at the (2, 2)
driver's full-width shards (f32 and bf16 c) and, in phase 5, on each
(2, 2) run's own exchange operands.

Prints a ``kernels`` JSON line, the card line, and last the ok line.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# the port itself: fails here (exit 1) outside a checkout of the repo
from repro_torch.checkpoint.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.base import TrainSettings, get_config, reduced  # noqa: E402
from repro_torch.core import algorithms as alg, cost_model, flatbuf  # noqa: E402
from repro_torch.core.collectives import WireMeter  # noqa: E402
from repro_torch.core.comm import CollectivePolicy, sync_comms  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.core.kvstore import KVStore  # noqa: E402
from repro_torch.core.sync_engine import make_sync_engine  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.fused_elastic import fused_elastic as fe  # noqa: E402
from repro_torch.kernels.fused_optim import fused_optim as fo  # noqa: E402
from repro_torch.kernels.fused_sgd import fused_sgd as fs  # noqa: E402
from repro_torch.kernels.quant_bucket import ops as qops, quant_bucket as qb  # noqa: E402
from repro_torch.kernels.tensor_reduce import tensor_reduce as tr  # noqa: E402
from repro_torch.kernels.timing import interleaved_ms, spread  # noqa: E402
from repro_torch.core import elastic as elastic_mod  # noqa: E402
from repro_torch.core.elastic import elastic_exchange_packed  # noqa: E402
from repro_torch.launch import shard_driver as sd  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    grad_spec, make_grad_fn, make_train_state, make_train_step, stacked_grads)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.sgd import flat_hp, sgd as sgd_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: (optimizer, lr) of the full-width slice; batch 8 x seq 512
SLICE = (("sgd", 0.1), ("adamw", 1e-3), ("adagrad", 3e-3))
SLICE_STEPS = 6

KERNELS = {
    "sgd_momentum_flat": dict(
        wrapper=fs.sgd_momentum_flat, plain=fs.sgd_momentum_flat_plain,
        source="src/repro_torch/kernels/fused_sgd/fused_sgd.py",
        replaces="src/repro/kernels/fused_sgd/fused_sgd.py:27",
        flops_per_elem=4, rtol=1e-6, atol=1e-7),
    "adamw_flat": dict(
        wrapper=fo.adamw_flat, plain=fo.adamw_flat_plain,
        source="src/repro_torch/kernels/fused_optim/fused_optim.py",
        replaces="src/repro/kernels/fused_optim/fused_optim.py:89",
        flops_per_elem=18, rtol=1e-5, atol=1e-7),
    "adagrad_flat": dict(
        wrapper=fo.adagrad_flat, plain=fo.adagrad_flat_plain,
        source="src/repro_torch/kernels/fused_optim/fused_optim.py",
        replaces="src/repro/kernels/fused_optim/fused_optim.py:35",
        flops_per_elem=7, rtol=1e-5, atol=1e-7),
}
OPT_KERNEL = {"sgd": "sgd_momentum_flat", "adamw": "adamw_flat",
              "adagrad": "adagrad_flat"}
#: slice 2's kernels; ``rtol``/``atol`` hold the f32 outputs of the
#: Triton ones (FMA and f64-emulated FMA agree but for a rare double
#: rounding), their bf16 outputs are held to 1 bf16 ulp beyond ``atol``;
#: an ``exact`` one (CUDA C++) is held ``==`` its plain version
ELASTIC_KERNELS = {
    "elastic_client_diff_flat": dict(
        wrapper=fe.elastic_client_diff_flat, plain=fe.elastic_client_diff_flat_plain,
        source="src/repro_torch/kernels/fused_elastic/fused_elastic.py",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:114",
        rtol=1e-6, atol=1e-7),
    "elastic_center_flat": dict(
        wrapper=fe.elastic_center_flat, plain=fe.elastic_center_flat_plain,
        source="src/repro_torch/csrc/fused_elastic.cu", route="cuda", exact=True,
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:131"),
    "elastic_exchange_flat_mc": dict(
        wrapper=fe.elastic_exchange_flat_mc, plain=fe.elastic_exchange_flat_mc_plain,
        source="src/repro_torch/kernels/fused_elastic/fused_elastic.py",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:151",
        rtol=1e-6, atol=1e-7),
}
#: slice 3's kernels: every output held to exact equality with the plain
#: version (codes, scales, decoded values, eqs. (2)/(3) at 0 ulp)
PS_KERNELS = {
    "quantize_wire": dict(
        wrapper=qb.quantize_wire, plain=qb.quantize_wire_plain,
        source="src/repro_torch/kernels/quant_bucket/quant_bucket.py",
        replaces="src/repro/kernels/quant_bucket/quant_bucket.py:168",
        flops_per_elem=5),
    "dequantize_wire": dict(
        wrapper=qb.dequantize_wire, plain=qb.dequantize_wire_plain,
        source="src/repro_torch/kernels/quant_bucket/quant_bucket.py",
        replaces="src/repro/kernels/quant_bucket/quant_bucket.py:199",
        flops_per_elem=1),
    "elastic_client_flat": dict(
        wrapper=fe.elastic_client_flat, plain=fe.elastic_client_flat_plain,
        source="src/repro_torch/csrc/fused_elastic.cu", route="cuda",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:83",
        flops_per_elem=3),
    "elastic_server_flat": dict(
        wrapper=fe.elastic_server_flat, plain=fe.elastic_server_flat_plain,
        source="src/repro_torch/csrc/fused_elastic.cu", route="cuda",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:97",
        flops_per_elem=3),
}
#: slice 4's kernels: every output held to exact equality with the plain
#: version (sums in member order, codes, scales, decoded values, eqs.
#: (2)+(3) at 0 ulp)
FAULT_KERNELS = {
    "group_reduce_flat": dict(
        wrapper=tr.group_reduce_flat, plain=tr.group_reduce_flat_plain,
        source="src/repro_torch/kernels/tensor_reduce/tensor_reduce.py",
        replaces="src/repro/kernels/tensor_reduce/tensor_reduce.py:31"),
    "quantize_flat": dict(
        wrapper=qb.quantize_flat, plain=qb.quantize_flat_plain,
        source="src/repro_torch/kernels/quant_bucket/quant_bucket.py",
        replaces="src/repro/kernels/quant_bucket/quant_bucket.py:56"),
    "dequantize_flat": dict(
        wrapper=qb.dequantize_flat, plain=qb.dequantize_flat_plain,
        source="src/repro_torch/kernels/quant_bucket/quant_bucket.py",
        replaces="src/repro/kernels/quant_bucket/quant_bucket.py:83"),
    "elastic_exchange_flat": dict(
        wrapper=fe.elastic_exchange_flat, plain=fe.elastic_exchange_flat_plain,
        source="src/repro_torch/kernels/fused_elastic/fused_elastic.py",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:69"),
}
ALL_KERNELS = {**KERNELS, **ELASTIC_KERNELS, **PS_KERNELS, **FAULT_KERNELS}
#: slice 2's full-width runs: 6 momentum-SGD steps each, global batch
#: 8 x 512 (C = 2 clients of 4 x 512; 4 devices of 2 x 512)
ESGD_STEPS = 6
ESGD_LR = 0.1
#: slice 3's full-width run: 4 workers in 2 clients, 2 x 512 tokens per
#: worker pass, 4 iterations per client, an exchange every 2
PS_ITERS = 4
PS_RUN = dict(mode="mpi_esgd", num_workers=4, num_clients=2, num_servers=1,
              lr=0.1, momentum=0.9, esgd_alpha=0.5, esgd_interval=2, epochs=1,
              steps_per_epoch=PS_ITERS, optimizer="sgd", seed=0)
#: slice 4's full-width (i) run: the [ps] layout over the per-leaf int8
#: codec under a straggle, a drop that one retry gets through, and a kill
FAULTS_SCHED = "straggle@0:unit=0:factor=3:duration=2;drop@2:unit=0:duration=1;kill@3:unit=1"
#: slice 4's full-width (iv) run: the p = 4 mpi-SGD driver, 6 steps of a
#: 12 x 512 global batch, device 3 killed before step 2 and back at step 4
DRIVE_SCHED = "kill@2:unit=3;restart@4:unit=3"
DRIVE_STEPS = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for k in ALL_KERNELS.values():
        k["wrapper"].launches = 0


def counts(kernels=KERNELS) -> dict:
    return {name: k["wrapper"].launches for name, k in kernels.items()}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_pair(kernel_fn, library_fn) -> tuple[float, float, str]:
    """Kernel and library yardstick timed in turns on the card (7 rounds
    of library x10, kernel x10, kernel x10, library x10): their median ms
    per call and a note with each side's median [min–max] and the verdict
    — the kernel loses (wins) when its fastest block is slower (its
    slowest block faster) than every one of the library's, else the two
    spreads overlap."""
    t = interleaved_ms(kernel_fn, library_fn)
    k, lib = t["kernel"], t["library"]
    verdict = ("kernel loses" if k["min"] > lib["max"] else
               "kernel wins" if k["max"] < lib["min"] else "spreads overlap")
    note = (f"interleaved: kernel {spread(k)} ms, library {spread(lib)} ms, "
            f"ratio {k['median'] / lib['median']:.4f} ({verdict})")
    return k["median"], lib["median"], note


def _ptxas_entries(report: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, shared memory bytes, spilled bytes) for every
    entry function in a ptxas ``-v`` report; names demangled with
    ``c++filt`` where the machine has it."""
    rows = []
    for block in re.split(r"Compiling entry function ", report)[1:]:
        name = re.match(r"'(\S+)'", block)[1]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", block))
        rows.append([name, int(regs[1]) if regs else -1,
                     int(smem[1]) if smem else 0, spills])
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        names = subprocess.run([cxxfilt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            for row, demangled in zip(rows, names):
                row[0] = _kernel_label(demangled)
    return [tuple(r) for r in rows]


def _kernel_label(demangled: str) -> str:
    """``kernel<template arguments>`` of a demangled signature, the
    fused_elastic.cu equation named (``(Eq)2`` -> ``center``)."""
    name = demangled.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return re.sub(r"\(Eq\)(\d)", lambda m: ("client", "server", "center")[int(m[1])],
                  name)


def phase_cuda_build() -> None:
    """Build every CUDA C++ library of the port from ``src/repro_torch/csrc``
    (one ``nvcc`` each, all at once) and print ptxas's registers, shared
    memory and spilled bytes for each kernel instantiation."""
    names = sorted(cuda_build.SIGNATURES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.build, names))
    log(f"[build] nvcc {', '.join(names)}: {time.perf_counter() - t0:.2f} s "
        f"(sm_90a, into build/cuda/)")
    for name in names:
        cuda_build.load_library(name)
        entries = _ptxas_entries(cuda_build.ptxas_report(name))
        regs, smem = [e[1] for e in entries], [e[2] for e in entries]
        log(f"[build] {name}: {len(entries)} kernels, ptxas: registers "
            f"{min(regs)}-{max(regs)}, shared memory {min(smem)}-{max(smem)} B, "
            f"spills {sum(e[3] for e in entries)} B (the full report: "
            f"build/cuda/*.ptxas.txt)")
        for kernel, r, b, spill in entries:
            log(f"[build]   {kernel}: {r} registers, {b} B shared memory, "
                f"{spill} B spilled")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_within_one_ulp(got, want, atol: float) -> None:
    """bf16 outputs within 1 bf16 ulp of the plain version's, beyond the
    f32 tolerance ``atol`` of the value before rounding (FMA contraction
    moves an f32 result that cancels to near zero by up to ``atol``)."""
    got, want = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    ulp = torch.clamp(ulp, min=2.0 ** -133)
    excess = ((got - want).abs() - ulp - atol).max()
    if float(excess) > 0:
        raise AssertionError(f"bf16 state differs from the plain version by "
                             f"{float(excess):.3e} beyond 1 ulp + atol")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — nothing measured")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | allow_tf32(matmul)="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at the main path's shape
# ---------------------------------------------------------------------------

def _make_inputs(name, n, state_dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda: torch.randn(n, generator=gen, device=dev)
    p, g = randn(), randn()
    if name == "sgd_momentum_flat":
        state = (randn() * 0.1).to(state_dtype)
        hp = torch.tensor([0.1, 0.9], device=dev)
    elif name == "adagrad_flat":
        state = (randn().abs() * 0.01).to(state_dtype)
        hp = torch.tensor([0.01, 1e-10], device=dev)
    else:
        state = torch.stack([randn() * 0.1, randn().abs() * 0.01]).to(state_dtype)
        t = 3
        hp = torch.tensor([3e-3, 0.9, 0.95, 1e-8, 0.1,
                           1 - 0.9 ** t, 1 - 0.95 ** t], device=dev)
    return p, state, g, hp


def _library_call(name, p, state, g, hp):
    """One PyTorch call computing the same update (a time yardstick the
    port never calls), or None where PyTorch has none on this device."""
    p1, s1 = p.clone(), state.clone()
    step = torch.tensor(3.0, device=p.device)
    if name == "sgd_momentum_flat":
        return lambda: torch._fused_sgd_(
            [p1], [g], [s1], weight_decay=0.0, momentum=0.9, lr=0.1,
            dampening=0.0, nesterov=False, maximize=False, is_first_step=False)
    if name == "adamw_flat":
        m1, v1 = s1[0], s1[1]
        return lambda: torch._fused_adamw_(
            [p1], [g], [m1], [v1], [], [step], lr=3e-3, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)
    call = lambda: torch._fused_adagrad_(
        [p1], [g], [s1], [step], lr=0.01, lr_decay=0.0, weight_decay=0.0,
        eps=1e-10, maximize=False)
    try:  # PyTorch's fused AdaGrad has had a CPU kernel only
        call()
    except (NotImplementedError, RuntimeError) as e:
        log(f"[kernels] adagrad_flat: no library yardstick on this device "
            f"({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        return None
    return call


def phase_kernels(n: int, dev) -> dict:
    results = {}
    for name, k in KERNELS.items():
        wrapper, plain = k["wrapper"], k["plain"]
        state_dtypes = ((torch.float32,) if name == "sgd_momentum_flat"
                        else (torch.float32, torch.bfloat16))
        for sd in state_dtypes:
            p, state, g, hp = _make_inputs(name, n, sd, dev)
            t0 = time.perf_counter()
            kp, ks = wrapper(p, state, g, hp)   # first call builds the kernel
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            rp, rs = plain(p, state, g, hp)
            torch.testing.assert_close(kp, rp, rtol=k["rtol"], atol=k["atol"])
            if sd == torch.float32:
                torch.testing.assert_close(ks, rs, rtol=k["rtol"], atol=k["atol"])
            else:
                bf16_within_one_ulp(ks, rs, k["atol"])
            err = max(float((kp - rp).abs().max()),
                      float((ks.float() - rs.float()).abs().max()))
            del kp, ks, rp, rs
            plain_ms = cuda_ms(lambda: plain(p, state, g, hp), reps=5, warmup=1)
            lib = _library_call(name, p, state, g, hp) if sd == torch.float32 else None
            note = ""
            if lib is None:
                ms, library_ms = cuda_ms(lambda: wrapper(p, state, g, hp), reps=20), None
            else:
                ms, library_ms, note = cuda_ms_pair(lambda: wrapper(p, state, g, hp), lib)
            moved = 2 * nbytes(p, state) + nbytes(g)   # read p,s,g; write p,s
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = k["flops_per_elem"] * n / F32_FLOPS_PER_S * 1e3
            tag = "f32" if sd == torch.float32 else "bf16"
            log(f"[kernels] {name} state={tag} n={n} first call {build_s:.2f} s "
                f"(build + run) max_abs_err={err:.3e} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms} "
                f"bytes={moved} bound_ms={max(bytes_ms, ops_ms):.4f} {note}")
            if sd == torch.float32:
                results[name] = {
                    "name": name, "route": k.get("route", "triton"), "source": k["source"],
                    "replaces": k["replaces"], "launches": None,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": library_ms,
                }
            del p, state, g, hp, lib
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------

def phase_small_reference(dev) -> None:
    """Reduced model, f32: 3 steps on the card (kernels) vs on the CPU
    (plain versions), from the same weights."""
    model = build_model(reduced(get_config("qwen2-0.5b")))
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=64, batch_size=8))
    for opt_name, kw in (("sgd", {}), ("adamw", dict(adam_eps=1e-5)),
                         ("adagrad", dict(adagrad_eps=1e-4))):
        lr = {"sgd": 0.1, "adamw": 3e-3, "adagrad": 1e-2}[opt_name]
        settings = TrainSettings(lr=lr, optimizer_name=opt_name, **kw)
        opt, sync = settings.optimizer(), settings.sync_config()
        out = {}
        for d in ("cpu", dev):
            state = make_train_state(model, opt, sync, device="cpu")
            state = tree_map(lambda a: a.to(d), state)
            step = make_train_step(model, opt, sync, device=d)
            losses = []
            for i in range(3):
                state, met = step(state, pipe.batch_at(0, i))
                losses.append(float(met["loss"]))
            out[str(torch.device(d).type)] = (losses, state["params"])
        (cl, cp), (gl, gp) = out["cpu"], out["cuda"]
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl),
                                   rtol=1e-4, atol=0)
        for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5)
        log(f"[slice:small] {opt_name}: card {gl} == cpu {cl} (rtol 1e-4); "
            f"params rtol 1e-3 atol 1e-5")


def _breakdown(model, settings, state, batch, dev) -> dict:
    """Where one step's time goes: grad (forward + backward) and the
    fused-update leg (pack + kernel + unpack), each timed alone."""
    opt, sync = settings.optimizer(), settings.sync_config()
    engine = make_sync_engine(opt, sync, spec=grad_spec(model))
    grad_fn = make_grad_fn(model)
    _, _, grads = grad_fn(state["params"], batch)
    grad_ms = cuda_ms(lambda: grad_fn(state["params"], batch), reps=3, warmup=1)
    update_ms = cuda_ms(lambda: engine.update(grads, state["opt"],
                                              state["params"]), reps=5, warmup=1)
    pack_ms = cuda_ms(lambda: engine.spec.pack(grads), reps=5, warmup=1)
    return {"grad_ms": grad_ms, "update_ms": update_ms, "pack_ms": pack_ms}


def phase_slice(dev) -> tuple[dict, dict, object]:
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    spec = grad_spec(model)
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=512,
                                    batch_size=8), device=dev)
    batches = [pipe.batch_at(0, i) for i in range(SLICE_STEPS)]
    log(f"[slice] full-width {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}->{cfg.padded_vocab} {cfg.dtype}; "
        f"FlatBuffer payload={spec.payload} size={spec.size}; "
        f"batch 8 x seq 512 ({8 * 512} tokens/step)")
    launches, report, params = {}, {}, None
    for opt_name, lr in SLICE:
        settings = TrainSettings(lr=lr, optimizer_name=opt_name)
        opt, sync = settings.optimizer(), settings.sync_config()
        state = make_train_state(model, opt, sync, device=dev)
        step = make_train_step(model, opt, sync, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        reset_counts()
        for batch in batches:
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        for name, c in got.items():
            want = SLICE_STEPS if name == OPT_KERNEL[opt_name] else 0
            if c != want:
                raise AssertionError(
                    f"{opt_name}: {name} launched {c} times in "
                    f"{SLICE_STEPS} steps, want {want}")
        launches[OPT_KERNEL[opt_name]] = got[OPT_KERNEL[opt_name]]
        if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
            raise AssertionError(f"{opt_name}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{opt_name}: loss did not fall {losses}")
        state_len = (state["opt"]["mv"] if opt_name == "adamw"
                     else state["opt"]).shape[-1]
        if state_len != flatbuf.shard_size(spec, 1, 2):
            raise AssertionError(f"{opt_name}: state length {state_len}")
        br = _breakdown(model, settings, state, batches[0], dev)
        steady = step_ms[1:]
        report[opt_name] = {"lr": lr, "losses": losses, "step_ms": step_ms,
                            "steady_step_ms": sum(steady) / len(steady),
                            "peak_mem_bytes": peak, **br}
        log(f"[slice] {opt_name} lr={lr}: losses {[round(x, 4) for x in losses]} "
            f"step_ms {[round(x, 2) for x in step_ms]} peak_mem "
            f"{peak / 2**30:.2f} GiB launches {got}")
        log(f"[slice] {opt_name} breakdown: grad (fwd+bwd) {br['grad_ms']:.2f} ms, "
            f"update leg (pack+kernel+unpack) {br['update_ms']:.2f} ms, "
            f"pack alone {br['pack_ms']:.2f} ms")
        params = state["params"]
        del state, step
        torch.cuda.empty_cache()
    log("[slice] " + json.dumps({"slice": report}))
    return launches, report, params


# ---------------------------------------------------------------------------
# phase 4: checkpoint round trip
# ---------------------------------------------------------------------------

def phase_checkpoint(params) -> None:
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "params.npz"
    try:
        save_checkpoint(str(path), params, step=SLICE_STEPS)
        restored, meta = restore_checkpoint(str(path), params)
        for a, b in zip(tree_leaves(restored), tree_leaves(params)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError("checkpoint round trip changed a leaf")
        log(f"[ckpt] round trip exact: {len(tree_leaves(params))} leaves, "
            f"{path.stat().st_size} bytes on disk, step {meta['step']}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 2 (slice 2): the elastic kernels at the shapes their paths give them
# ---------------------------------------------------------------------------

def _elastic_inputs(name, spec, w_dtype, dev):
    """The operands a main-path launch gets: the (2, 2) driver's stacked
    (4, total) packed params and centers (client-diff), its (4, total/2)
    center shards and reduce-scattered difference sums (center), the
    C = 2 step's (2, size) packed replicas and (size,) center (mc)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    _, total = flatbuf.shard_geometry(spec.size, 2, 2)   # the pod group, R = 2
    if name == "elastic_client_diff_flat":
        w = randn(4, total)
        c = (w + 0.01 * randn(4, total)).to(w_dtype)
        return (w.to(w_dtype), c), torch.tensor(0.5 / 2, device=dev)
    if name == "elastic_center_flat":
        c = randn(4, total // 2).to(w_dtype)
        return (c, 0.01 * randn(4, total // 2)), torch.tensor(0.5 / 2, device=dev)
    w = randn(2, spec.size)
    c = (w[0] + 0.01 * randn(spec.size)).to(w_dtype)
    return (w.to(w_dtype), c), torch.tensor(0.5 / 2, device=dev)


def _hold(got, want, rtol, atol, dtype) -> float:
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    else:
        bf16_within_one_ulp(got, want, atol)
    return float((got.float() - want.float()).abs().max())


def _plain_rows(plain, args, alpha):
    """The plain version over the stacked operands, one leading row per
    call: its f64 fused-multiply-add temporaries for a whole (4, n)
    buffer would not fit on the card beside the kernel's operands."""
    if args[0].dim() == 1 or plain is fe.elastic_exchange_flat_mc_plain:
        return plain(*args, alpha)
    outs = [plain(*(a[i] for a in args), alpha) for i in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def phase_elastic_kernels(spec, dev) -> dict:
    results = {}
    for name, k in ELASTIC_KERNELS.items():
        wrapper, plain = k["wrapper"], k["plain"]
        for w_dtype in (torch.float32, torch.bfloat16):
            args, alpha = _elastic_inputs(name, spec, w_dtype, dev)
            t0 = time.perf_counter()
            got = wrapper(*args, alpha)        # first call builds the kernel
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            want = _plain_rows(plain, args, alpha)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if k.get("exact"):
                err = _hold_exact(name, got, want)
            else:
                err = max(_hold(g, w, k["rtol"], k["atol"], g.dtype)
                          for g, w in zip(got, want))
            moved = nbytes(*args) + nbytes(*got)
            del got, want
            plain_ms = cuda_ms(lambda: _plain_rows(plain, args, alpha),
                               reps=2, warmup=1)
            library_ms, note = None, ""
            if name == "elastic_center_flat":
                a = float(alpha)
                ms, library_ms, note = cuda_ms_pair(
                    lambda: wrapper(*args, alpha),
                    lambda: torch.add(args[0], args[1], alpha=a))
            else:
                ms = cuda_ms(lambda: wrapper(*args, alpha), reps=10)
            elems = args[0].numel()
            flops = {"elastic_client_diff_flat": 3, "elastic_center_flat": 2,
                     "elastic_exchange_flat_mc": 4}[name] * elems
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOPS_PER_S * 1e3
            tag = "f32" if w_dtype == torch.float32 else "bf16"
            held = "==" if k.get("exact") else "within tolerance"
            log(f"[kernels] {name} w={tag} shape={tuple(args[0].shape)} first "
                f"call {build_s:.2f} s (build + run) max_abs_err={err:.3e} ({held}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms} "
                f"bytes={moved} bound_ms={max(bytes_ms, ops_ms):.4f} {note}")
            if w_dtype == torch.float32:
                results[name] = {
                    "name": name, "route": k.get("route", "triton"), "source": k["source"],
                    "replaces": k["replaces"], "launches": None,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": library_ms,
                }
            del args, alpha
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 5: slice 2 — mpi-ESGD and mpi-SGD across emulated devices
# ---------------------------------------------------------------------------

def _esgd_sync(mode, clients, wire):
    return SyncConfig(mode=mode, num_clients=clients, esgd_interval=2,
                      esgd_alpha=0.5,
                      policy=CollectivePolicy(method="ring", num_rings=2,
                                              wire_dtype=wire))


def _close_trees(got, want, tol) -> None:
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu().float(), b.float(), **tol)


def phase_small_esgd(dev) -> None:
    """Reduced model, f32: 3 steps of the (2, 2) shard driver (mpi_esgd,
    int8 wire, interval 2) and of the C = 2 multi-client step on the card
    against the same steps on the CPU, from the same weights. Over the
    int8 wire a value next to a rounding boundary can take the
    neighbouring code on one device and not the other (the card's and the
    CPU's gradients differ in the last bits), so its params are held to
    the reference's band for a quantized leg (rtol 1e-2, atol 2e-3); the
    C = 2 step to rtol 1e-3 / atol 1e-5."""
    model = build_model(reduced(get_config("qwen2-0.5b")))
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=64, batch_size=8))
    opt = sgd_optimizer(0.1, momentum=0.9)
    runs = {
        "driver (2, 2) mpi_esgd int8": (
            _esgd_sync("mpi_esgd", 2, "int8"),
            lambda sync, d: sd.make_driver_state(model, opt, sync, (2, 2), device="cpu"),
            lambda sync, d: sd.make_emulated_step(model, opt, sync, (2, 2)),
            lambda b: sd.shard_batch(b, (2, 2)), dict(rtol=1e-2, atol=2e-3)),
        "train C=2 mpi_esgd": (
            _esgd_sync("mpi_esgd", 2, None),
            lambda sync, d: make_train_state(model, opt, sync, device="cpu"),
            lambda sync, d: make_train_step(model, opt, sync, device=d),
            lambda b: sd.shard_batch(b, 2), dict(rtol=1e-3, atol=1e-5)),
    }
    for label, (sync, init, mk_step, split, tol) in runs.items():
        out = []
        for d in ("cpu", dev):
            state = tree_map(lambda a: a.to(d), init(sync, d))
            step = mk_step(sync, d)
            losses = []
            for i in range(3):
                state, met = step(state, split(pipe.batch_at(0, i)))
                losses.append(float(met["loss"]))
            out.append((losses, state))
        (cl, cs), (gl, gs) = out
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl),
                                   rtol=1e-4, atol=0)
        for key in ("params", "center"):
            _close_trees(gs[key], cs[key], tol)
        log(f"[esgd:small] {label}: card {gl} == cpu {cl} (rtol 1e-4); "
            f"params and center within {tol}")


def _wire_per_step(spec, sync, p) -> tuple[float, float]:
    """(every step's grad + param leg bytes, an exchange step's extra
    elastic leg bytes) per device, from the cost model."""
    world = sd.driver_world(sync, p)
    grad_comm, ex_comm = sync_comms(sync, world)
    wire = grad_comm.wire
    gp = grad_comm.static_size
    _, gtotal = flatbuf.shard_geometry(spec.size, gp, grad_comm.rings_for(spec.nbytes))
    legs = (cost_model.grad_leg_bytes(gtotal * 4, gp, wire)
            + cost_model.param_leg_bytes(gtotal * 4, gp, wire))
    exch = 0.0
    if ex_comm is not None:
        ep = ex_comm.static_size
        _, etotal = flatbuf.shard_geometry(spec.size, ep, ex_comm.rings_for(spec.nbytes))
        exch = cost_model.elastic_leg_bytes(etotal * 4, ep, wire)
    return legs, exch


def _hold_stacked_sgd(label, p, v, g, hp) -> float:
    """``sgd_momentum_flat`` on the stacked operands a run's update hands
    it (flattened, as the path launches it) against its plain version,
    row by row (one row per emulated device or client: the plain
    version's f32 temporaries for the whole buffer would not fit beside
    the run's state), at phase 2's tolerances."""
    k = KERNELS["sgd_momentum_flat"]
    rows, n = math.prod(p.shape[:-1]), p.shape[-1]
    new_p, new_v = fs.sgd_momentum_flat(p.reshape(-1), v.reshape(-1),
                                        g.reshape(-1), hp)
    err = 0.0
    for i in range(rows):
        want = fs.sgd_momentum_flat_plain(p.reshape(rows, n)[i], v.reshape(rows, n)[i],
                                          g.reshape(rows, n)[i], hp)
        for got, w in zip((new_p.view(rows, n)[i], new_v.view(rows, n)[i]), want):
            torch.testing.assert_close(got, w, rtol=k["rtol"], atol=k["atol"])
            err = max(err, float((got.float() - w.float()).abs().max()))
    log(f"[esgd] {label}: sgd_momentum_flat on the stacked {tuple(p.shape)} "
        f"{p.dtype} shard == plain, row by row (rtol {k['rtol']}, atol "
        f"{k['atol']}): max_abs_err={err:.3e}")
    return err


class _CenterHold:
    """Wraps the sharded exchange's eq. (2) pass
    (``core.elastic.elastic_center_flat``) for one exchange: each launch's
    output held ``==`` its plain version on the operands the path gave it
    (row by row), and their layout recorded."""

    def __init__(self):
        self.err, self.calls = 0.0, []
        self._orig = elastic_mod.elastic_center_flat

    def __call__(self, c, ds, alpha):
        out = self._orig(c, ds, alpha)
        rows = lambda t: t.reshape(-1, t.shape[-1])
        want = _plain_rows(fe.elastic_center_flat_plain, (rows(c), rows(ds)), alpha)
        self.err = max(self.err, _hold_exact("elastic_center_flat", rows(out), want))
        self.calls.append(f"{tuple(c.shape)} {str(c.dtype)[6:]}/{str(ds.dtype)[6:]} "
                          f"contiguous {c.is_contiguous() and ds.is_contiguous()} "
                          f"offsets mod 16 B {c.data_ptr() % 16}/{ds.data_ptr() % 16}")
        return out

    def __enter__(self):
        elastic_mod.elastic_center_flat = self
        return self

    def __exit__(self, *exc):
        elastic_mod.elastic_center_flat = self._orig


def _driver_split(model, opt, sync, p, state, shard, spec, label) -> dict:
    """One driver step's pieces, each timed alone: forward + backward of
    every device, the gradient leg's collectives (reduce-scatter +
    allgather), the fused update kernel on the stacked shard, and the
    whole elastic exchange (packs, kernels, its collectives)."""
    shape, _ = sd._factorize(p)
    world = sd.driver_world(sync, p)
    grad_comm, _ = sync_comms(sync, world)
    to_world = lambda t: t.reshape(shape + tuple(t.shape[1:]))
    params = tree_map(to_world, state["params"])
    wbatch = {k: to_world(v.to(state["step"].device)) for k, v in shard.items()}
    grad_fn = make_grad_fn(model)
    out = {"grad_ms": cuda_ms(lambda: stacked_grads(grad_fn, params, wbatch,
                                                    len(shape)), reps=2, warmup=1)}
    _, _, grads = stacked_grads(grad_fn, params, wbatch, len(shape))
    nr = grad_comm.rings_for(spec.nbytes)
    _, total = flatbuf.shard_geometry(spec.size, grad_comm.static_size, nr)
    g_buf = flatbuf.pack_padded(spec, grads, total)
    del grads
    if grad_comm.static_size > 1:
        out["collectives_ms"] = cuda_ms(
            lambda: grad_comm.allgather(grad_comm.reduce_scatter(g_buf, num_rings=nr),
                                        num_rings=nr), reps=2, warmup=1)
        g_shard = grad_comm.reduce_scatter(g_buf, num_rings=nr)
    else:
        out["collectives_ms"] = 0.0
        g_shard = g_buf
    del g_buf
    p_shard = flatbuf.pack_padded(spec, params, total)
    if grad_comm.static_size > 1:
        p_shard = grad_comm.shard_select(p_shard, num_rings=nr)
    mom = to_world(state["opt"])
    hp = flat_hp(opt.hyper, g_shard.device)
    out["sgd_max_abs_err"] = _hold_stacked_sgd(label, p_shard, mom, g_shard, hp)
    out["kernel_ms"] = cuda_ms(lambda: fs.sgd_momentum_flat(
        p_shard.reshape(-1), mom.reshape(-1), g_shard.reshape(-1), hp), reps=5)
    del g_shard, p_shard
    _, dev_ex = sd.make_device_step(model, opt, sync, world=world)
    if dev_ex is not None:
        wstate = tree_map(to_world, state)
        with _CenterHold() as hold:      # the run's own exchange operands
            dev_ex(wstate)
        out["center_max_abs_err"] = hold.err
        log(f"[esgd] {label}: elastic_center_flat on the exchange's operands "
            f"({'; '.join(hold.calls)}) == plain, row by row: "
            f"max_abs_err={hold.err:.3e}")
        out["exchange_ms"] = cuda_ms(lambda: dev_ex(wstate), reps=2, warmup=1)
    else:
        out["exchange_ms"] = 0.0
    return out


def _train_split(model, opt, sync, state, batch, spec, label) -> dict:
    """The C = 2 step's pieces, each timed alone: forward + backward of
    both clients, the update leg (packs + ONE kernel over both clients +
    unpack), the update kernel alone, and the flat exchange."""
    engine = make_sync_engine(opt, sync, spec=spec)
    grad_fn = make_grad_fn(model)
    out = {"grad_ms": cuda_ms(lambda: stacked_grads(grad_fn, state["params"], batch),
                              reps=2, warmup=1)}
    _, _, grads = stacked_grads(grad_fn, state["params"], batch)
    out["update_leg_ms"] = cuda_ms(lambda: engine.update(grads, state["opt"],
                                                         state["params"]), reps=3, warmup=1)
    g, w = spec.pack(grads), spec.pack(state["params"])
    hp = flat_hp(opt.hyper, g.device)
    out["sgd_max_abs_err"] = _hold_stacked_sgd(label, w, state["opt"], g, hp)
    out["kernel_ms"] = cuda_ms(lambda: fs.sgd_momentum_flat(
        w.reshape(-1), state["opt"].reshape(-1), g.reshape(-1), hp), reps=5)
    del g, w, grads
    out["collectives_ms"] = 0.0
    out["exchange_ms"] = cuda_ms(lambda: engine.exchange_multiclient(
        state["params"], state["center"], sync.esgd_alpha / sync.num_clients),
        reps=3, warmup=1)
    return out


def _device_busy(step, state, batch) -> tuple:
    """One more step under ``torch.profiler``: (device busy share, device
    ms summed over the kernels and copies on the card, wall ms with the
    profiler on), or Nones when the trace shows no device time. The
    share is of the profiled wall clock, which the profiler lengthens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an op's own row repeats its kernels' time
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    if not busy_ms:
        return None, None, wall_ms
    return busy_ms / wall_ms, busy_ms, wall_ms


def _check_launches(label, got, want) -> None:
    for name, c in got.items():
        if c != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {c} times in "
                                 f"{ESGD_STEPS} steps, want {want.get(name, 0)}")


def phase_esgd(dev) -> tuple[dict, dict]:
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    spec = grad_spec(model)
    opt = sgd_optimizer(ESGD_LR, momentum=0.9)
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=512,
                                    batch_size=8), device=dev)
    batches = [pipe.batch_at(0, i) for i in range(ESGD_STEPS)]
    half = ESGD_STEPS // 2    # exchanges at steps 0, 2, 4 (interval 2)
    runs = [
        ("train C=2 mpi_esgd", "train", _esgd_sync("mpi_esgd", 2, None), 2,
         {"elastic_exchange_flat_mc": half, "sgd_momentum_flat": ESGD_STEPS}),
        ("driver (2, 2) mpi_esgd f32", "driver", _esgd_sync("mpi_esgd", 2, None), (2, 2),
         {"elastic_client_diff_flat": half, "elastic_center_flat": half,
          "sgd_momentum_flat": ESGD_STEPS}),
        ("driver (2, 2) mpi_esgd int8", "driver", _esgd_sync("mpi_esgd", 2, "int8"), (2, 2),
         {"elastic_client_diff_flat": half, "elastic_center_flat": half,
          "sgd_momentum_flat": ESGD_STEPS}),
        ("driver p=4 mpi_sgd int8", "driver", _esgd_sync("mpi_sgd", 1, "int8"), 4,
         {"sgd_momentum_flat": ESGD_STEPS}),
    ]
    log(f"[esgd] full-width {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"{cfg.dtype}; FlatBuffer size={spec.size}; global batch 8 x 512 "
        f"(C=2: 4 x 512 per client; 4 devices: 2 x 512 per device); "
        f"momentum SGD lr {ESGD_LR}, alpha 0.5, interval 2, {ESGD_STEPS} steps")
    launches, report = {}, {}
    for label, kind, sync, p, want in runs:
        meter = WireMeter()
        if kind == "train":
            state = make_train_state(model, opt, sync, device=dev)
            step = make_train_step(model, opt, sync, device=dev)
            split = lambda b: sd.shard_batch(b, 2)
            legs, exch = 0.0, 0.0    # one process, local geometry: no wire
        else:
            state = sd.make_driver_state(model, opt, sync, p, device=dev)
            step = sd.make_emulated_step(model, opt, sync, p, meter=meter)
            split = lambda b, p=p: sd.shard_batch(b, p)
            legs, exch = _wire_per_step(spec, sync, p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, wire = [], [], []
        reset_counts()
        for i, batch in enumerate(batches):
            meter.reset()
            t0 = time.perf_counter()
            state, met = step(state, split(batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
            wire.append(meter.bytes)
            want_bytes = legs + (exch if i % 2 == 0 else 0.0)
            if meter.bytes != want_bytes:
                raise AssertionError(f"{label} step {i}: {meter.bytes} wire "
                                     f"bytes counted, cost model {want_bytes}")
        got = counts(ALL_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        _check_launches(label, got, want)
        if not all(x == x and abs(x) != float("inf") for x in losses):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: loss did not fall {losses}")
        for name, c in want.items():
            launches.setdefault(name, c)
        if kind == "train":
            br = _train_split(model, opt, sync, state, split(batches[0]), spec, label)
        else:
            br = _driver_split(model, opt, sync, p, state, split(batches[0]), spec, label)
        # an exchange step (the state's step count is even)
        share, busy_ms, wall_ms = _device_busy(step, state, split(batches[0]))
        br.update(device_busy_share=share, device_busy_ms=busy_ms,
                  profiled_step_ms=wall_ms)
        steady = step_ms[1:]
        report[label] = {"losses": losses, "step_ms": step_ms,
                         "steady_step_ms": sum(steady) / len(steady),
                         "peak_mem_bytes": peak, "wire_bytes_per_step": wire,
                         "launches": {k: v for k, v in got.items() if v}, **br}
        log(f"[esgd] {label}: losses {[round(x, 4) for x in losses]} step_ms "
            f"{[round(x, 2) for x in step_ms]} peak_mem {peak / 2**30:.2f} GiB "
            f"launches {report[label]['launches']} wire bytes/step {wire} "
            f"(cost model: {legs:.0f} + {exch:.0f} on exchange steps)")
        log(f"[esgd] {label} split: fwd+bwd {br['grad_ms']:.2f} ms, collectives "
            f"(RS + AG) {br['collectives_ms']:.2f} ms, update kernel "
            f"{br['kernel_ms']:.3f} ms, exchange {br['exchange_ms']:.2f} ms; "
            f"profiled exchange step {wall_ms:.1f} ms, device busy "
            f"{busy_ms} ms (share {share})")
        del state, step
        torch.cuda.empty_cache()
    log("[esgd] " + json.dumps({"esgd": report}))
    return launches, report


# ---------------------------------------------------------------------------
# phase 2 (slice 3): the PS tier's kernels at the packed full-width buffer
# ---------------------------------------------------------------------------

def _wire_input(n, dev):
    """The packed buffer's stand-in: normal values, one all-zero bucket and
    one bucket of ±k.5 at scale 1 (ties that round half to even)."""
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    x[:128] = 0.0
    x[128] = 127.0
    x[129:256] = torch.arange(-63, 64, device=dev) + 0.5
    return x


def _hold_ps(name, args, got=None) -> float:
    """One PS-tier kernel against its plain version on the same operands:
    every output equal. Returns the max |kernel − plain| of the values
    (0.0), after checking equality exactly."""
    k = PS_KERNELS[name]
    got = k["wrapper"](*args) if got is None else got
    return _hold_exact(name, got, k["plain"](*args))


def _hold_exact(name, got, want) -> float:
    """Every output of a kernel equal to its plain version's (values,
    dtypes, shapes); returns the max |kernel − plain| (0.0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"{name}: kernel != plain ({bad} elements of "
                                 f"{tuple(w.shape)} {w.dtype})")
    return max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def _hold_yardstick(name, got, want) -> None:
    """A yardstick must compute the kernel's function: its output equal to
    the plain version's on the same operands before it is timed."""
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: the library yardstick != the plain version")


def phase_ps_kernels(spec, dev) -> dict:
    n = spec.size
    results = {}
    x = _wire_input(n, dev)
    c = x + 0.01 * torch.randn(n, generator=torch.Generator(device=dev).manual_seed(4),
                               device=dev)
    alpha = torch.tensor(PS_RUN["esgd_alpha"], device=dev)
    # dequantize_wire decodes what the quantize case encoded
    cases = {"quantize_wire": lambda: (x,),
             "dequantize_wire": lambda: (*codec, n),
             "elastic_client_flat": lambda: (x, c, alpha),
             "elastic_server_flat": lambda: (x, c, alpha)}
    for name, make_args in cases.items():
        k = PS_KERNELS[name]
        args = make_args()
        t0 = time.perf_counter()
        got = k["wrapper"](*args)              # first call builds the kernel
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        err = _hold_ps(name, args, got)
        if name == "quantize_wire":
            codec = got
            # the ±k.5 bucket at scale 1 rounds half to even
            torch.testing.assert_close(
                qb.dequantize_wire_plain(codec[0][:256], codec[1][:2], 256)[129:],
                torch.round(torch.arange(-63, 64, device=dev) + 0.5), rtol=0, atol=0)
        outs = got if isinstance(got, tuple) else (got,)
        moved = nbytes(*(a for a in args if torch.is_tensor(a) and a.dim())) + nbytes(*outs)
        del got, outs
        plain_ms = cuda_ms(lambda: k["plain"](*args), reps=2, warmup=1)
        library_ms, note, a = None, "", float(alpha)
        if name == "elastic_client_flat":      # w + α (w̃ − w) = eq. (3)
            ms, library_ms, note = cuda_ms_pair(lambda: k["wrapper"](*args),
                                                lambda: torch.lerp(x, c, a))
        elif name == "elastic_server_flat":    # w̃ + α (w − w̃) = eq. (2)
            ms, library_ms, note = cuda_ms_pair(lambda: k["wrapper"](*args),
                                                lambda: torch.lerp(c, x, a))
        elif name == "dequantize_wire":        # codes × scale, one bucket a row
            nb = n // qb.WIRE_BLOCK
            mul = lambda: torch.mul(codec[0][:nb * qb.WIRE_BLOCK].view(nb, qb.WIRE_BLOCK),
                                    codec[1][:nb].view(nb, 1))
            _hold_yardstick(name, mul().view(-1), k["plain"](*args)[:nb * qb.WIRE_BLOCK])
            ms, library_ms, note = cuda_ms_pair(lambda: k["wrapper"](*args), mul)
            note += (f"; library torch.mul(codes.view({nb}, {qb.WIRE_BLOCK}), "
                     f"scales.view({nb}, 1)), held == plain"
                     + (f" on the {nb * qb.WIRE_BLOCK} values of whole buckets"
                        if n % qb.WIRE_BLOCK else ""))
        else:
            ms = cuda_ms(lambda: k["wrapper"](*args), reps=10)
            log(f"[kernels] {name}: no library yardstick — no one PyTorch call "
                "computes the per-128-bucket absmax int8 codec")
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = k["flops_per_elem"] * n / F32_FLOPS_PER_S * 1e3
        log(f"[kernels] {name} n={n} first call {build_s:.2f} s (build + run) "
            f"max_abs_err={err:.3e} (all outputs ==) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms} bytes={moved} "
            f"bound_ms={max(bytes_ms, ops_ms):.4f} {note}")
        results[name] = {
            "name": name, "route": k.get("route", "triton"), "source": k["source"],
            "replaces": k["replaces"], "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }
        del args
        torch.cuda.empty_cache()
    del x, c, codec
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 6: slice 3 — the in-process PS tier through algorithms.run
# ---------------------------------------------------------------------------

def _grad_loss_only(grad_fn):
    """``algorithms.run``'s grad_fn: (params, batch) -> (loss, grads)."""
    def fn(params, batch):
        loss, _, grads = grad_fn(params, batch)
        return loss, grads
    return fn


def _eval_fn(model, batch):
    def fn(params) -> float:
        with torch.no_grad():
            return float(model.loss_fn(params, batch)[0])
    return fn


def phase_ps_small(dev) -> None:
    """Reduced model, f32: every mode of ``algorithms.run`` (and mpi-/dist-
    ESGD over the int8 wire) on the card against the same run on the CPU,
    from the same weights. The simulated clock must be equal; losses and
    the eval metrics within rtol 1e-4, as in [esgd:small]."""
    model = build_model(reduced(get_config("qwen2-0.5b")))
    p0 = model.init(device="cpu", seed=0)
    grad = _grad_loss_only(make_grad_fn(model))
    data = dict(vocab_size=256, seq_len=64, batch_size=2, steps_per_epoch=2)
    held = TokenPipeline(DataConfig(**data, shard=99)).batch_at(0, 0)
    runs = [(m, None) for m in alg.MODES] + [("mpi_esgd", "int8"), ("dist_esgd", "int8")]
    for mode, wire in runs:
        cfg = alg.AlgoConfig(mode=mode, num_workers=4, num_clients=2, num_servers=1,
                             epochs=2, steps_per_epoch=2, esgd_interval=2,
                             compute_time=0.2, jitter=0.1, model_bytes=1e7,
                             policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                     wire_dtype=wire))
        out = {}
        for d in ("cpu", dev):
            key = torch.device(d).type
            out[key] = alg.run(
                cfg, lambda gen, d=d: tree_map(lambda a: a.to(d), p0), grad,
                _eval_fn(model, {k: v.to(d) for k, v in held.items()}),
                lambda w, d=d: TokenPipeline(DataConfig(**data, shard=w), device=d),
                device=d)
        c, g = out["cpu"], out["cuda"]
        for f in ("times", "epochs", "epoch_time", "mean_staleness", "live_clients",
                  "pushed_bytes"):
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(f"[ps:small] {mode} {wire}: {f} card "
                                     f"{getattr(g, f)} != cpu {getattr(c, f)}")
        torch.testing.assert_close(torch.tensor(g.losses), torch.tensor(c.losses),
                                   rtol=1e-4, atol=0)
        torch.testing.assert_close(torch.tensor(g.metrics), torch.tensor(c.metrics),
                                   rtol=1e-4, atol=0)
        log(f"[ps:small] {mode} wire={wire}: clock {g.times} / epoch_time "
            f"{g.epoch_time:.6f} / staleness {g.mean_staleness:.3f} == cpu; "
            f"losses {[round(x, 5) for x in g.losses]} metrics "
            f"{[round(x, 5) for x in g.metrics]} within rtol 1e-4 of cpu")


class _ExchangeRecorder:
    """Wraps the runner's Elastic2 (``algorithms.elastic_client_packed``,
    or ``elastic_client_update`` on the per-leaf path) for one run and
    keeps the last exchange's operands — the pushed replica (= the
    client's params) and the center as it was before that push — for the
    holds after it."""

    def __init__(self, attr: str = "elastic_client_packed"):
        self.last = None
        self._attr = attr
        self._orig = getattr(alg, attr)

    def __call__(self, params, center, alpha):
        self.last = (params, center, alpha)
        return self._orig(params, center, alpha)

    def __enter__(self):
        setattr(alg, self._attr, self)
        return self

    def __exit__(self, *exc):
        setattr(alg, self._attr, self._orig)


def _hold_last_exchange(spec, params, center, alpha, wire) -> dict:
    """The PS-tier kernels on the run's own last exchange operands, each
    against its plain version: the codec on the packed push (int8), the
    server rule on (what crossed the wire, the old center), the client
    rule on (the push, the old center)."""
    errs = {}
    x = spec.pack(params)
    c = spec.pack(center)
    a = torch.tensor(float(alpha), device=x.device)
    recv = x
    if wire == "int8":
        errs["quantize_wire"] = _hold_ps("quantize_wire", (x,))
        codes, scales = qb.quantize_wire(x)
        errs["dequantize_wire"] = _hold_ps("dequantize_wire", (codes, scales, spec.size))
        recv = qb.dequantize_wire(codes, scales, spec.size)
        del codes, scales
    errs["elastic_server_flat"] = _hold_ps("elastic_server_flat", (recv, c, a))
    errs["elastic_client_flat"] = _hold_ps("elastic_client_flat", (x, c, a))
    return errs


def _ps_split(cfg, model, grad, params, center, batches) -> dict:
    """One completion's pieces, each timed alone on the run's last exchange
    operands: forward + backward of the client's two workers, the
    intra-client allreduce, the push (wire + server rule), the client's
    Elastic2 and the update."""
    group = alg._worker_group(cfg)
    out = {"fwd_bwd_ms": cuda_ms(lambda: alg._member_grads(grad, params, batches),
                                 reps=2, warmup=1)}
    _, stacked = alg._member_grads(grad, params, batches)
    out["allreduce_ms"] = cuda_ms(lambda: group.emulate_reduce(stacked), reps=3, warmup=1)
    _, g = alg._client_grad(grad, params, batches, group)
    del stacked
    kv = KVStore.create("async_mpi", num_workers=cfg.num_workers,
                        num_clients=cfg.num_clients, wire_dtype=cfg.effective_wire_dtype,
                        flat_exchange=cfg.flat_exchange)
    kv.init("centers", center)
    kv.set_elastic(cfg.esgd_alpha)
    elastic2 = (alg.elastic_client_packed if cfg.flat_exchange
                else alg.elastic_client_update)
    out["push_ms"] = cuda_ms(lambda: kv.push("centers", params), reps=3, warmup=1)
    out["elastic2_ms"] = cuda_ms(
        lambda: elastic2(params, center, cfg.esgd_alpha), reps=3, warmup=1)
    opt = alg._make_opt(cfg, params)
    state = opt.init(params)
    out["update_ms"] = cuda_ms(lambda: opt.update(g, state, params), reps=3, warmup=1)
    out["exchange_completion_ms"] = sum(out.values())
    out["plain_completion_ms"] = (out["fwd_bwd_ms"] + out["allreduce_ms"]
                                  + out["update_ms"])

    def completion():
        _, grads = alg._client_grad(grad, params, batches, group)
        kv.push("centers", params)
        p = elastic2(params, kv.value("centers"), cfg.esgd_alpha)
        opt.update(grads, state, p)

    out["device_busy_share"], out["device_busy_ms"], out["profiled_ms"] = \
        _device_busy(lambda *_: completion(), None, None)
    return out


def phase_ps(dev) -> tuple[dict, dict, dict]:
    cfg_model = get_config("qwen2-0.5b")
    model = build_model(cfg_model)
    spec = grad_spec(model)
    grad = _grad_loss_only(make_grad_fn(model))
    data = dict(seed=0, vocab_size=256, seq_len=512, batch_size=2,
                steps_per_epoch=PS_ITERS, num_shards=PS_RUN["num_workers"])
    held = TokenPipeline(DataConfig(**dict(data, shard=99)), device=dev).batch_at(0, 0)
    evaluate = _eval_fn(model, held)
    log(f"[ps] full-width {cfg_model.name} {cfg_model.dtype}: FlatBuffer payload="
        f"{spec.payload} size={spec.size}; {PS_RUN['num_workers']} workers in "
        f"{PS_RUN['num_clients']} clients, 2 x 512 tokens per worker pass, "
        f"{PS_ITERS} iterations per client (8 completions), interval "
        f"{PS_RUN['esgd_interval']} (4 exchanges), momentum SGD lr "
        f"{PS_RUN['lr']}, alpha {PS_RUN['esgd_alpha']}")
    launches, errs, report = {}, {}, {}
    for wire in ("int8", None):
        cfg = alg.AlgoConfig(**PS_RUN, model_bytes=4.0 * spec.payload,
                             policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                     wire_dtype=wire))
        params0 = model.init(device=dev, seed=0)
        start_loss = evaluate(params0)
        tree_bytes = sum(l.numel() * l.element_size() for l in tree_leaves(params0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _ExchangeRecorder() as rec:
            t0 = time.perf_counter()
            hist = alg.run(cfg, lambda gen: params0, grad, evaluate,
                           lambda w: TokenPipeline(DataConfig(**dict(data, shard=w)),
                                                   device=dev), device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        got = counts(ALL_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        want = {"quantize_wire": 4 if wire else 0, "dequantize_wire": 4 if wire else 0,
                "elastic_server_flat": 4, "elastic_client_flat": 4,
                "sgd_momentum_flat": 2 * PS_ITERS}
        label = f"mpi_esgd wire={wire or 'f32'}"
        for name, cnt in got.items():
            if cnt != want.get(name, 0):
                raise AssertionError(f"[ps] {label}: {name} launched {cnt} times, "
                                     f"want {want.get(name, 0)}")
        if wire:
            launches.update({k: v for k, v in want.items() if k in PS_KERNELS})
        if not all(math.isfinite(x) for x in hist.losses + hist.metrics):
            raise AssertionError(f"[ps] {label}: non-finite loss {hist.losses} "
                                 f"{hist.metrics}")
        if not hist.metrics[-1] < start_loss:
            raise AssertionError(f"[ps] {label}: the center's eval loss "
                                 f"{hist.metrics[-1]} is not below its start {start_loss}")
        pushes = 4
        want_bytes = (pushes * cost_model.ps_wire_nbytes(spec.payload, "int8") if wire
                      else pushes * tree_bytes)   # f32 wire: the tree as it is
        if hist.pushed_bytes != want_bytes:
            raise AssertionError(f"[ps] {label}: {hist.pushed_bytes} PS wire bytes, "
                                 f"cost model {want_bytes}")
        params, center, alpha = rec.last
        held_errs = _hold_last_exchange(spec, params, center, alpha, wire)
        for name, e in held_errs.items():
            errs[name] = max(errs.get(name, 0.0), e)
        log(f"[ps] {label}: losses {[round(x, 4) for x in hist.losses]} center eval "
            f"{start_loss:.4f} -> {hist.metrics[-1]:.4f}; launches "
            f"{ {k: v for k, v in got.items() if v} }; PS wire bytes {hist.pushed_bytes} "
            f"== cost model; kernels == plain on the last exchange's operands "
            f"({sorted(held_errs)}); simulated epoch {hist.epoch_time:.4f} s")
        pipes = [TokenPipeline(DataConfig(**dict(data, shard=w)), device=dev)
                 for w in range(2)]
        split = _ps_split(cfg, model, grad, params, center,
                          [p.batch_at(0, PS_ITERS - 1) for p in pipes])
        del params, center, rec, params0
        report[label] = {"losses": hist.losses, "center_eval": [start_loss] + hist.metrics,
                         "run_ms": wall_ms, "mean_completion_ms": wall_ms / (2 * PS_ITERS),
                         "peak_mem_bytes": peak, "pushed_bytes": hist.pushed_bytes,
                         "launches": {k: v for k, v in got.items() if v}, **split}
        log(f"[ps] {label}: run {wall_ms:.1f} ms for 8 completions (set-up and one "
            f"eval included) = {wall_ms / 8:.1f} ms each; peak_mem "
            f"{peak / 2**30:.2f} GiB; split: fwd+bwd (2 workers) "
            f"{split['fwd_bwd_ms']:.2f} ms, intra-client allreduce "
            f"{split['allreduce_ms']:.2f} ms, push (wire + server rule) "
            f"{split['push_ms']:.2f} ms, Elastic2 {split['elastic2_ms']:.2f} ms, "
            f"update {split['update_ms']:.2f} ms -> exchange completion "
            f"{split['exchange_completion_ms']:.1f} ms, plain completion "
            f"{split['plain_completion_ms']:.1f} ms; profiled exchange completion "
            f"{split['profiled_ms']:.1f} ms, device busy {split['device_busy_ms']} ms "
            f"(share {split['device_busy_share']})")
        torch.cuda.empty_cache()
    log("[ps] " + json.dumps({"ps": report}))
    return launches, errs, report


# ---------------------------------------------------------------------------
# phase 2 (slice 4): the faults slice's kernels at the full-width shapes
# ---------------------------------------------------------------------------

def _row(name, err, ms, plain_ms, moved, flops, library_ms) -> dict:
    k = FAULT_KERNELS[name]
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"name": name, "route": "triton", "source": k["source"],
            "replaces": k["replaces"], "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def _per_leaf(fn, args_list):
    """``fn`` over every leaf's arguments: one launch per leaf, as the
    per-leaf paths (``local_reduce``, ``ops.compress``) make them."""
    return lambda: [fn(*a) for a in args_list]


def phase_fault_kernels(model, spec, dev) -> dict:
    """group_reduce_flat on a G = 2 bf16 tree of the full width (one
    launch per leaf, as a list push of two grad trees runs it), the QBLOCK
    codec over every leaf of the tree cast to f32 (one push each way), and
    elastic_exchange_flat on the packed buffer."""
    results = {}
    p0, p1 = model.init(device=dev, seed=0), model.init(device=dev, seed=1)
    leaves0, leaves1 = tree_leaves(p0), tree_leaves(p1)
    values = sum(l.numel() for l in leaves0)
    log(f"[kernels] slice 4 operands: the full-width tree has {len(leaves0)} "
        f"leaves (the layers stacked), {values} values, "
        f"{sum(-(-l.numel() // qb.QBLOCK) for l in leaves0)} QBLOCK blocks; "
        f"largest leaf {max(l.numel() for l in leaves0)} values")

    # group_reduce_flat: one (2, N) bf16 group per leaf
    groups = [(torch.stack([a, b]).reshape(2, -1),) for a, b in zip(leaves0, leaves1)]
    t0 = time.perf_counter()
    outs = _per_leaf(tr.group_reduce_flat, groups)()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    err = max(_hold_exact("group_reduce_flat", o, tr.group_reduce_flat_plain(*g))
              for o, g in zip(outs, groups))
    moved = sum(nbytes(g[0]) for g in groups) + nbytes(*outs)
    del outs
    plain_ms = cuda_ms(_per_leaf(tr.group_reduce_flat_plain, groups), reps=2, warmup=1)
    ms, library_ms, note = cuda_ms_pair(
        _per_leaf(tr.group_reduce_flat, groups),
        _per_leaf(lambda x: x.float().sum(0).to(x.dtype), groups))
    results["group_reduce_flat"] = _row("group_reduce_flat", err, ms, plain_ms,
                                        moved, values, library_ms)
    log(f"[kernels] group_reduce_flat G=2 bf16, {len(groups)} launches over the "
        f"tree: first call {build_s:.2f} s (build + run) max_abs_err={err:.3e} "
        f"(==) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(x.float().sum(0).to(x.dtype) per leaf) bytes={moved} "
        f"bound_ms={results['group_reduce_flat']['bound_ms']:.4f} {note}")
    del groups, p1, leaves1
    torch.cuda.empty_cache()

    # the QBLOCK codec: every leaf flattened and cast to f32, as compress does
    flats = [(l.reshape(-1).float(),) for l in leaves0]
    big = max(range(len(flats)), key=lambda i: flats[i][0].numel())
    t0 = time.perf_counter()
    codecs = _per_leaf(qb.quantize_flat, flats)()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    err = max(_hold_exact("quantize_flat", c, qb.quantize_flat_plain(*f))
              for c, f in zip(codecs, flats))
    moved = sum(nbytes(f[0]) + nbytes(*c) for f, c in zip(flats, codecs))
    ms = cuda_ms(_per_leaf(qb.quantize_flat, flats), reps=5)
    plain_ms = cuda_ms(_per_leaf(qb.quantize_flat_plain, flats), reps=2, warmup=1)
    big_ms = cuda_ms(lambda: qb.quantize_flat(*flats[big]), reps=10)
    results["quantize_flat"] = _row("quantize_flat", err, ms, plain_ms, moved,
                                    5 * values, None)
    log(f"[kernels] quantize_flat, {len(flats)} launches (one push): first call "
        f"{build_s:.2f} s (build + run) max_abs_err={err:.3e} (codes and scales "
        f"==) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None (no one "
        f"PyTorch call computes the per-1024-block absmax int8 codec) "
        f"bytes={moved} bound_ms={results['quantize_flat']['bound_ms']:.4f}; the "
        f"largest leaf ({flats[big][0].numel()} values) alone {big_ms:.4f} ms")
    dargs = [(c, s, f[0].numel()) for (c, s), f in zip(codecs, flats)]
    t0 = time.perf_counter()
    outs = _per_leaf(qb.dequantize_flat, dargs)()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    err = max(_hold_exact("dequantize_flat", o, qb.dequantize_flat_plain(*a))
              for o, a in zip(outs, dargs))
    moved = sum(nbytes(a[0], a[1]) for a in dargs) + nbytes(*outs)
    del outs
    plain_ms = cuda_ms(_per_leaf(qb.dequantize_flat_plain, dargs), reps=2, warmup=1)
    # the yardstick: codes × scale, one QBLOCK block a row, per leaf; a leaf
    # that is not whole blocks is timed on its whole-block prefix
    mul_args = [(c[:(m // qb.QBLOCK) * qb.QBLOCK].view(-1, qb.QBLOCK),
                 s[:m // qb.QBLOCK].view(-1, 1)) for c, s, m in dargs]
    for (c, s), a in zip(mul_args, dargs):
        _hold_yardstick("dequantize_flat", torch.mul(c, s).view(-1),
                        qb.dequantize_flat_plain(*a)[:c.numel()])
    ragged = [m for _, _, m in dargs if m % qb.QBLOCK]
    ms, library_ms, note = cuda_ms_pair(_per_leaf(qb.dequantize_flat, dargs),
                                        _per_leaf(torch.mul, mul_args))
    big_ms = cuda_ms(lambda: qb.dequantize_flat(*dargs[big]), reps=10)
    results["dequantize_flat"] = _row("dequantize_flat", err, ms, plain_ms, moved,
                                      values, library_ms)
    log(f"[kernels] dequantize_flat, {len(dargs)} launches (one push): first call "
        f"{build_s:.2f} s (build + run) max_abs_err={err:.3e} (==) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (torch.mul(codes.view("
        f"nb, {qb.QBLOCK}), scales.view(nb, 1)) per leaf, held == plain; "
        f"{len(ragged)} of {len(dargs)} leaves not whole blocks, timed on their "
        f"whole-block prefixes: {sum(m % qb.QBLOCK for m in ragged)} of their "
        f"{sum(ragged)} values left out) bytes={moved} "
        f"bound_ms={results['dequantize_flat']['bound_ms']:.4f}; the largest "
        f"leaf alone {big_ms:.4f} ms {note}")
    del flats, codecs, dargs, mul_args
    torch.cuda.empty_cache()

    # elastic_exchange_flat on the packed buffer
    w = spec.pack(p0)
    c = w + 0.01 * torch.randn(w.shape, generator=torch.Generator(device=dev)
                               .manual_seed(5), device=dev)
    del p0, leaves0
    alpha = torch.tensor(0.5, device=dev)
    t0 = time.perf_counter()
    got = fe.elastic_exchange_flat(w, c, alpha)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    err = _hold_exact("elastic_exchange_flat", got,
                      fe.elastic_exchange_flat_plain(w, c, alpha))
    moved = nbytes(w, c) + nbytes(*got)
    del got
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fe.elastic_exchange_flat(w, c, alpha), reps=10)
    plain_ms = cuda_ms(lambda: fe.elastic_exchange_flat_plain(w, c, alpha), reps=2,
                       warmup=1)
    a = float(alpha)
    lerp_ms = cuda_ms(lambda: (torch.lerp(w, c, a), torch.lerp(c, w, a)), reps=10)
    results["elastic_exchange_flat"] = _row("elastic_exchange_flat", err, ms,
                                            plain_ms, moved, 4 * w.numel(), None)
    log(f"[kernels] elastic_exchange_flat n={w.numel()} first call {build_s:.2f} s "
        f"(build + run) max_abs_err={err:.3e} (both outputs ==) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms=None (no one PyTorch call computes "
        f"both outputs; two torch.lerp calls, a note: {lerp_ms:.4f} ms) "
        f"bytes={moved} bound_ms={results['elastic_exchange_flat']['bound_ms']:.4f}")
    del w, c
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 7: slice 4 — faults and elastic membership
# ---------------------------------------------------------------------------

#: the reference's fault schedules (tests/test_faults.py), kill steps
#: scaled to a run of 4 steps (sync) or ~4 iterations per client (async)
SMALL_FAULT_RUNS = (
    ("mpi_sgd", None, True,
     dict(faults="kill@2:unit=1;straggle@0:unit=0:factor=3:duration=5",
          barrier_timeout=1.0)),
    ("dist_sgd", None, True,
     dict(faults="kill@2:unit=1;straggle@0:unit=0:factor=3:duration=5",
          barrier_timeout=1.0)),
    ("mpi_asgd", None, True, dict(faults="kill@2:unit=1;drop@3:unit=0:duration=9")),
    ("mpi_esgd", "int8", False,
     dict(faults="kill@2:unit=1;straggle@0:unit=0:factor=3:duration=8")),
)
FAULT_COUNTERS = ("times", "epochs", "epoch_time", "mean_staleness", "degraded_syncs",
                  "late_pushes", "live_clients", "membership_epochs", "pushed_bytes")


class _CpuInitDriverState:
    """``drive`` builds its state from ``make_driver_state``; for a card
    against CPU comparison both runs start from the CPU's initial state."""

    def __enter__(self):
        self._orig = sd.make_driver_state
        orig = self._orig

        def from_cpu(*args, device="cuda", **kw):
            return tree_map(lambda t: t.to(device), orig(*args, device="cpu", **kw))

        sd.make_driver_state = from_cpu
        return self

    def __exit__(self, *exc):
        sd.make_driver_state = self._orig


def phase_faults_small(dev) -> None:
    model = build_model(reduced(get_config("qwen2-0.5b")))
    p0 = model.init(device="cpu", seed=0)
    grad = _grad_loss_only(make_grad_fn(model))
    data = dict(vocab_size=256, seq_len=64, batch_size=2, steps_per_epoch=2)
    held = TokenPipeline(DataConfig(**data, shard=99)).batch_at(0, 0)
    for mode, wire, flat, kw in SMALL_FAULT_RUNS:
        cfg = alg.AlgoConfig(mode=mode, num_workers=4, num_clients=2, num_servers=1,
                             epochs=2, steps_per_epoch=2, esgd_interval=2,
                             compute_time=0.2, jitter=0.1, model_bytes=1e7,
                             flat_exchange=flat, **kw,
                             policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                     wire_dtype=wire))
        c, g = (alg.run(
            cfg, lambda gen, d=d: tree_map(lambda a: a.to(d), p0), grad,
            _eval_fn(model, {k: v.to(d) for k, v in held.items()}),
            lambda w, d=d: TokenPipeline(DataConfig(**data, shard=w), device=d),
            device=d) for d in ("cpu", dev))
        for f in FAULT_COUNTERS:
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(f"[faults:small] {mode} {kw['faults']}: {f} card "
                                     f"{getattr(g, f)} != cpu {getattr(c, f)}")
        if g.live_clients != cfg.effective_clients - 1 or g.membership_epochs != 1:
            raise AssertionError(f"[faults:small] {mode}: live {g.live_clients}, "
                                 f"epochs {g.membership_epochs}")
        torch.testing.assert_close(torch.tensor(g.losses), torch.tensor(c.losses),
                                   rtol=1e-4, atol=0)
        torch.testing.assert_close(torch.tensor(g.metrics), torch.tensor(c.metrics),
                                   rtol=1e-4, atol=0)
        log(f"[faults:small] {mode} wire={wire} flat_exchange={flat} "
            f"faults={kw['faults']!r}: clock {g.times} degraded {g.degraded_syncs} "
            f"late {g.late_pushes} live {g.live_clients} epochs "
            f"{g.membership_epochs} == cpu; losses within rtol 1e-4 of cpu")
    opt = sgd_optimizer(0.1, momentum=0.9)
    sync = _esgd_sync("mpi_sgd", 1, None)
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=64, batch_size=12))
    batches = [pipe.batch_at(0, i) for i in range(4)]
    with _CpuInitDriverState():
        (cs, ch), (gs, gh) = (sd.drive(model, opt, sync, batches, p=4, device=d,
                                       log_every=1,
                                       faults="kill@1:unit=3;restart@3:unit=3")
                              for d in ("cpu", dev))
    events = [e for e in gh if "event" in e]
    if events != [e for e in ch if "event" in e] or \
            [e["event"] for e in events] != ["reconfigure", "join"]:
        raise AssertionError(f"[faults:small] drive events {events} != cpu")
    losses = [e["loss"] for e in gh if "loss" in e]
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor([e["loss"] for e in ch if "loss" in e]),
                               rtol=1e-4, atol=0)
    _close_trees(gs["params"], cs["params"], dict(rtol=1e-3, atol=1e-5))
    log(f"[faults:small] drive p=4 kill@1 / restart@3 of device 3: rows 4 -> "
        f"{events[0]['p_new']} -> {events[1]['p_new']}, events == cpu, losses "
        f"{[round(x, 4) for x in losses]} within rtol 1e-4, params rtol 1e-3")


class _PushCounter:
    """Counts the KVStore pushes of one run (the deliveries that reached
    the store: a lost push never does)."""

    def __init__(self):
        self.count = 0
        self._orig = KVStore.push

    def __enter__(self):
        orig, counter = self._orig, self

        def push(kv, *args, **kw):
            counter.count += 1
            return orig(kv, *args, **kw)

        KVStore.push = push
        return self

    def __exit__(self, *exc):
        KVStore.push = self._orig


def _faults_run(model, spec, grad, evaluate, data, dev) -> dict:
    """(i) mpi-ESGD over the per-leaf int8 PS wire under FAULTS_SCHED."""
    cfg = alg.AlgoConfig(**PS_RUN, model_bytes=4.0 * spec.payload, flat_exchange=False,
                         faults=FAULTS_SCHED,
                         policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                 wire_dtype="int8"))
    params0 = model.init(device=dev, seed=0)
    leaves = len(tree_leaves(params0))
    start_loss = evaluate(params0)
    push_bytes = qops.compressed_bytes(params0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _PushCounter() as pushes, _ExchangeRecorder("elastic_client_update") as rec:
        t0 = time.perf_counter()
        hist = alg.run(cfg, lambda gen: params0, grad, evaluate,
                       lambda w: TokenPipeline(DataConfig(**dict(data, shard=w)),
                                               device=dev), device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    got = counts(ALL_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    label = "[faults] (i) mpi_esgd int8 per-leaf"
    # unit 1 runs iterations 0-2 (pushes at 0, 2) and dies at dispatch of
    # 3; unit 0 drains the 8 completions with iterations 0-4 (pushes at 0,
    # 2, 4); its drop at 2 lasts one attempt, so the first retry lands
    if pushes.count != 5 or hist.late_pushes != 0:
        raise AssertionError(f"{label}: {pushes.count} pushes delivered, "
                             f"{hist.late_pushes} late; the schedule implies 5, 0")
    want = {"quantize_flat": leaves * pushes.count, "dequantize_flat": leaves * pushes.count,
            "sgd_momentum_flat": 2 * PS_ITERS}
    for name, cnt in got.items():
        if cnt != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {cnt} times, want "
                                 f"{want.get(name, 0)} (the packed elastic kernels: 0)")
    if hist.pushed_bytes != push_bytes * pushes.count:
        raise AssertionError(f"{label}: {hist.pushed_bytes} PS wire bytes, want "
                             f"{pushes.count} x compressed_bytes {push_bytes}")
    if (hist.live_clients, hist.membership_epochs) != (1, 1):
        raise AssertionError(f"{label}: live {hist.live_clients}, epochs "
                             f"{hist.membership_epochs}")
    if not all(math.isfinite(x) for x in hist.losses + hist.metrics):
        raise AssertionError(f"{label}: non-finite loss {hist.losses} {hist.metrics}")
    if not hist.metrics[-1] < start_loss:
        raise AssertionError(f"{label}: the center's eval loss {hist.metrics[-1]} is "
                             f"not below its start {start_loss}")
    params, center, _ = rec.last
    pipes = [TokenPipeline(DataConfig(**dict(data, shard=w)), device=dev) for w in range(2)]
    split = _ps_split(cfg, model, grad, params, center,
                      [p.batch_at(0, PS_ITERS - 1) for p in pipes])
    del params, center, rec, params0
    torch.cuda.empty_cache()
    log(f"{label}: faults {FAULTS_SCHED!r}; losses {[round(x, 4) for x in hist.losses]} "
        f"center eval {start_loss:.4f} -> {hist.metrics[-1]:.4f}; {pushes.count} "
        f"pushes delivered, late {hist.late_pushes}, live {hist.live_clients}, "
        f"membership epochs {hist.membership_epochs}; launches "
        f"{ {k: v for k, v in got.items() if v} } (= {leaves} leaves x "
        f"{pushes.count} pushes each way); PS wire bytes {hist.pushed_bytes} == "
        f"{pushes.count} x {push_bytes}; simulated epoch {hist.epoch_time:.4f} s")
    log(f"{label}: run {wall_ms:.1f} ms (set-up and one eval included); peak_mem "
        f"{peak / 2**30:.2f} GiB; split: fwd+bwd (2 workers) {split['fwd_bwd_ms']:.2f} "
        f"ms, allreduce {split['allreduce_ms']:.2f} ms, push (per-leaf codec + "
        f"server rule) {split['push_ms']:.2f} ms, Elastic2 (per leaf) "
        f"{split['elastic2_ms']:.2f} ms, update {split['update_ms']:.2f} ms -> "
        f"exchange completion {split['exchange_completion_ms']:.1f} ms; profiled "
        f"{split['profiled_ms']:.1f} ms, device busy {split['device_busy_ms']} ms "
        f"(share {split['device_busy_share']})")
    return {"launches": {k: v for k, v in got.items() if v}, "pushes": pushes.count,
            "losses": hist.losses, "center_eval": [start_loss] + hist.metrics,
            "run_ms": wall_ms, "peak_mem_bytes": peak, "pushed_bytes": hist.pushed_bytes,
            **split}


def _list_push(model, grad, batches, dev) -> dict:
    """(ii) ``KVStore("dist_sync").push("grads", [g0, g1])`` of two
    full-width bf16 grad trees."""
    params = model.init(device=dev, seed=0)
    grads = [grad(params, b)[1] for b in batches]
    del params
    kv = KVStore.create("dist_sync", num_workers=1)
    kv.init("grads", tree_map(torch.zeros_like, grads[0]))
    leaves = len(tree_leaves(grads[0]))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kv.push("grads", grads)
    torch.cuda.synchronize()
    push_ms = (time.perf_counter() - t0) * 1e3
    got = counts(ALL_KERNELS)
    if got != {**{k: 0 for k in ALL_KERNELS}, "group_reduce_flat": leaves}:
        raise AssertionError(f"[faults] (ii) list push launches {got}, want "
                             f"group_reduce_flat {leaves}")
    err = 0.0
    for out, a, b in zip(tree_leaves(kv.value("grads")), *map(tree_leaves, grads)):
        want = tr.group_reduce_flat_plain(torch.stack([a, b]).reshape(2, -1))
        err = max(err, _hold_exact("group_reduce_flat", out.reshape(-1), want))
    log(f"[faults] (ii) list push of two full-width bf16 grad trees: "
        f"group_reduce_flat launched {got['group_reduce_flat']} times (one per "
        f"leaf), the stored sum == the plain version's, {push_ms:.2f} ms "
        f"(stacks included)")
    del grads, kv
    torch.cuda.empty_cache()
    return {"launches": got["group_reduce_flat"], "max_abs_err": err, "push_ms": push_ms}


def _exchange_packed(model, spec, dev) -> tuple[int, float]:
    """(iii) ``elastic_exchange_packed(params, center, 0.5)`` at full
    width, at f32 and over the int8 wire, against the plain path."""
    params, center = model.init(device=dev, seed=0), model.init(device=dev, seed=1)
    launches, err = 0, 0.0
    for wire in (None, "int8"):
        reset_counts()
        t0 = time.perf_counter()
        new_w, new_c = elastic_exchange_packed(params, center, 0.5, wire_dtype=wire)
        torch.cuda.synchronize()
        ex_ms = (time.perf_counter() - t0) * 1e3
        got = counts(ALL_KERNELS)
        want = {"elastic_exchange_flat": 1}
        if wire:
            want.update(quantize_wire=1, dequantize_wire=1)
        if got != {**{k: 0 for k in ALL_KERNELS}, **want}:
            raise AssertionError(f"[faults] (iii) wire={wire}: launches {got}")
        launches = got["elastic_exchange_flat"]
        w = spec.pack(params)
        if wire:
            codes, scales = qb.quantize_wire_plain(w)
            w = qb.dequantize_wire_plain(codes, scales, spec.size)
            del codes, scales
        pw, pc = fe.elastic_exchange_flat_plain(w, spec.pack(center),
                                                torch.tensor(0.5, device=dev))
        del w
        for got_t, want_t in ((new_w, spec.unpack(pw)), (new_c, spec.unpack(pc))):
            for a, b in zip(tree_leaves(got_t), tree_leaves(want_t)):
                err = max(err, _hold_exact("elastic_exchange_flat", a, b))
        del pw, pc, new_w, new_c
        torch.cuda.empty_cache()
        log(f"[faults] (iii) elastic_exchange_packed wire={wire or 'f32'}: launches "
            f"{ {k: v for k, v in got.items() if v} }, both trees == the plain "
            f"path's, {ex_ms:.2f} ms (packs and unpacks included)")
    return launches, err


def _drive_faults(model, spec, opt, dev) -> dict:
    """(iv) the p = 4 mpi-SGD shard driver under DRIVE_SCHED."""
    sync = _esgd_sync("mpi_sgd", 1, None)
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=512,
                                    batch_size=12), device=dev)
    batches = [pipe.batch_at(0, i) for i in range(DRIVE_STEPS)]
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, hist = sd.drive(model, opt, sync, batches, p=4, device=dev, log_every=1,
                           faults=DRIVE_SCHED,
                           callback=lambda e: stamps.append((e, time.perf_counter())))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    got = counts(ALL_KERNELS)
    events = [e for e in hist if "event" in e]
    kill, join = events
    label = "[faults] (iv) drive p=4 mpi_sgd"
    if ([e["event"] for e in events] != ["reconfigure", "join"]
            or (kill["p_old"], kill["p_new"], join["p_new"]) != (4, 3, 4)):
        raise AssertionError(f"{label}: events {events}")
    if kill["moved_bytes"] != cost_model.reshard_leg_bytes(
            kill["state_nbytes"], 4, survivors=3):
        raise AssertionError(f"{label}: kill moved {kill['moved_bytes']} B")
    if join["moved_bytes"] != cost_model.join_reshard_bytes(join["state_nbytes"], 3):
        raise AssertionError(f"{label}: join moved {join['moved_bytes']} B")
    rows = [tree_leaves(state["params"])[0].shape[0]]
    if rows != [4] or got.get("sgd_momentum_flat") != DRIVE_STEPS:
        raise AssertionError(f"{label}: rows {rows}, launches {got}")
    losses = [e["loss"] for e in hist if "loss" in e]
    if len(losses) != DRIVE_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    # each step's time: from the previous logged step to this one's log,
    # so a step behind a membership change carries the reconfiguration
    step_ms, prev = [], t0
    for e, t in stamps:
        if "loss" in e:
            step_ms.append((t - prev) * 1e3)
            prev = t
    log(f"{label}: faults {DRIVE_SCHED!r}, 6 steps of 12 x 512: rows 4 -> "
        f"{kill['p_new']} (step {kill['step']}) -> {join['p_new']} (step "
        f"{join['step']}); kill moved {kill['moved_bytes']:.0f} B == "
        f"reshard_leg_bytes, join moved {join['moved_bytes']:.0f} B == "
        f"join_reshard_bytes; losses {[round(x, 4) for x in losses]}; step_ms "
        f"{[round(x, 1) for x in step_ms]} (steps 2 and 4 include the "
        f"membership change); run {wall_ms:.1f} ms; peak_mem {peak / 2**30:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return {"events": events, "losses": losses, "step_ms": step_ms, "run_ms": wall_ms,
            "peak_mem_bytes": peak}


def phase_faults(dev) -> tuple[dict, dict, dict]:
    cfg_model = get_config("qwen2-0.5b")
    model = build_model(cfg_model)
    spec = grad_spec(model)
    grad = _grad_loss_only(make_grad_fn(model))
    data = dict(seed=0, vocab_size=256, seq_len=512, batch_size=2,
                steps_per_epoch=PS_ITERS, num_shards=PS_RUN["num_workers"])
    held = TokenPipeline(DataConfig(**dict(data, shard=99)), device=dev).batch_at(0, 0)
    log(f"[faults] full-width {cfg_model.name} {cfg_model.dtype}, depth uncut")
    report = {"(i) run": _faults_run(model, spec, grad, _eval_fn(model, held), data, dev)}
    pipe = TokenPipeline(DataConfig(**data), device=dev)
    report["(ii) list push"] = _list_push(model, grad,
                                          [pipe.batch_at(0, i) for i in range(2)], dev)
    ex_launches, ex_err = _exchange_packed(model, spec, dev)
    report["(iv) drive"] = _drive_faults(model, spec, sgd_optimizer(0.1, momentum=0.9), dev)
    launches = {"quantize_flat": report["(i) run"]["launches"]["quantize_flat"],
                "dequantize_flat": report["(i) run"]["launches"]["dequantize_flat"],
                "group_reduce_flat": report["(ii) list push"]["launches"],
                "elastic_exchange_flat": ex_launches}
    errs = {"group_reduce_flat": report["(ii) list push"]["max_abs_err"],
            "elastic_exchange_flat": ex_err}
    log("[faults] " + json.dumps({"faults": report}, default=str))
    return launches, errs, report


def main() -> None:
    card = phase_device()
    phase_cuda_build()
    dev = torch.device("cuda")
    spec = grad_spec(build_model(get_config("qwen2-0.5b")))
    n = flatbuf.shard_size(spec, 1, 2)
    kernels = phase_kernels(n, dev)
    kernels.update(phase_elastic_kernels(spec, dev))
    kernels.update(phase_ps_kernels(spec, dev))
    kernels.update(phase_fault_kernels(build_model(get_config("qwen2-0.5b")), spec, dev))
    phase_small_reference(dev)
    launches, _, params = phase_slice(dev)
    phase_checkpoint(params)
    del params
    torch.cuda.empty_cache()
    phase_small_esgd(dev)
    esgd_launches, report = phase_esgd(dev)
    for name, c in esgd_launches.items():
        launches.setdefault(name, c)
    phase_ps_small(dev)
    ps_launches, ps_errs, _ = phase_ps(dev)
    launches.update(ps_launches)
    for name, e in ps_errs.items():     # worst hold: phase 2 or the run's operands
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)
    phase_faults_small(dev)
    fault_launches, fault_errs, _ = phase_faults(dev)
    launches.update(fault_launches)
    for name, e in fault_errs.items():  # worst hold: phase 2 or the [faults] run
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)
    for name, key in (("sgd_momentum_flat", "sgd_max_abs_err"),
                      ("elastic_center_flat", "center_max_abs_err")):
        row = kernels[name]                 # worst hold: phase 2 or a run's operands
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [r[key] for r in report.values() if key in r])
    for name, row in kernels.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
