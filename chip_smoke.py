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
              b) full-width qwen2-0.5b in bf16 (8 of its 24 layers), batch
                 8 x seq 512, through
                 make_train_state -> make_train_step -> FlatEngine, a few
                 mpi-SGD steps each for sgd, adamw and adagrad, with the
                 kernels' launch counts set to 0 just before and read just
                 after; step time, its breakdown, and peak memory
  4. ckpt     npz checkpoint round trip of the trained params
  5. esgd     slice 2, mpi-ESGD and mpi-SGD across emulated devices:
              a) the reduced model, 3 steps of the (2, 2) shard driver
                 (mpi_esgd, int8 wire) and of the C = 2 multi-client step,
                 card against CPU
              b) full-width qwen2-0.5b in bf16 (8 of its 24 layers), 6
                 momentum-SGD steps per
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
              b) full-width qwen2-0.5b in bf16 (8 of its 24 layers),
                 mpi-ESGD with 4 workers in
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
              b) [faults] full-width qwen2-0.5b in bf16 (8 of its 24
                 layers): (i) mpi-ESGD
                 through algorithms.run over the per-leaf int8 PS wire
                 (flat_exchange=False) under a straggle, a retried drop
                 and a kill; (ii) a list push of two full-width bf16 grad
                 trees; (iii) elastic_exchange_packed at f32 and over the
                 int8 wire; (iv) the p = 4 mpi-SGD shard driver under a
                 kill and a rejoin — launch counts, byte counts and the
                 membership outcomes checked, times and peak memory
  8. overlap  slice 7, backward overlap (SyncConfig.overlap, mpi-SGD):
              a) [overlap:small] the reduced model, 3 steps on the card
                 against the CPU: make_train_step at p = 1 (sgd, adamw,
                 adagrad), the p = 4 driver (sgd; f32, bf16, int8 wire)
                 and the (2, 2) driver (f32); losses within rtol 1e-4;
                 the int8 codes and each bucket leg on identical inputs
                 card == CPU
              b) [overlap] full-width qwen2-0.5b in bf16 (8 of its 24
                 layers), 4 schedule
                 buckets: the p = 4 driver (momentum SGD, 4 steps of
                 2 x 512 per device) over the f32 and then the int8 wire,
                 each beside the same run without overlap; then
                 make_train_step at p = 1 with AdamW (8 x 512, 3 steps).
                 Per run: launch counts (one per step over the whole
                 bucket-major shard), WireMeter bytes == the per-bucket
                 legs + the one trailing allgather of the cost model,
                 the issue-order share == cost_model.overlap_fraction,
                 losses finite and falling and within the reference's
                 band of the run without overlap, the optimizer kernel
                 on one more step's own operands held against its plain
                 version, step time, its split, peak memory, device busy
  9. serve    slice 8, serving (no kernel on this path: every serve phase
              sets the 14 launch counts to 0 first and fails unless they
              read 0 after), the new phases' wall time printed:
              a) [serve:small] the four reduced dense configs, f32, the
                 same weights: 12 serve steps' logits and the cache on the
                 card within rtol 1e-4 / atol 1e-5 of the CPU, and
                 BatchedServer's greedy tokens equal
              b) [serve] full-width qwen2-0.5b in bf16: BatchedServer
                 (batch 8, max_seq 256, 64-token prompts, 64 new tokens;
                 every step's logits within SERVE_BAND_REL of forward over
                 the same 128 tokens); decode_32k (B 128, a 32,768-slot
                 cache filled in place, KV == 51,539,607,552 B, 8 steps,
                 no copy of the cache in a profiled step); prefill_32k
                 (forward 1 x 32,768); the chunked attention against one
                 block at S = 4096 — ms per token beside the bytes bound,
                 tokens/s, peak memory, device busy
              c) [serve:configs] qwen2.5-3b, qwen3-4b, phi3-medium-14b at
                 full width in bf16, one at a time: init on the card (tree
                 numel, init peak), BatchedServer batch 4, 32 + 32 tokens
                 with b)'s holds, ms per token beside the weight bound

 10. families slice 9, the MoE, SSM and hybrid families, the wall time of
              each phase printed:
              a) [families:small] qwen2-moe-a2.7b, mixtral-8x7b, mamba2-130m
                 and zamba2-1.2b reduced, f32, the same weights: 3
                 momentum-SGD steps card == CPU (rtol 1e-4) with
                 sgd_momentum_flat launched once per step, 12 serve steps'
                 logits and caches within rtol 1e-4 / atol 1e-5, greedy
                 tokens equal, no kernel launched while serving
              b) [families] full width in bf16, the bytes reckoned first:
                 training (3 steps) mamba2-130m 8 x 512, zamba2-1.2b 4 x 512,
                 qwen2-moe-a2.7b cut to 3 layers 4 x 512 — falling losses,
                 sgd_momentum_flat launches == steps, the kernel held on one
                 more step's operands, step ms, peak memory, device busy;
                 serving (BatchedServer; depths cut for phase 15 d) mamba2-130m (8
                 layers) B 8 64 + 64, zamba2-1.2b (12) B 4 32 + 32,
                 qwen2-moe-a2.7b (4) and mixtral-8x7b (2) B 4 32 + 32 — ms
                 per token beside the
                 bytes bound (weights + cache), tokens/s, peak memory, busy,
                 0 launches, no host sync; mamba2 / zamba2 decode against
                 forward over the served tokens, in f32 within 1e-3 of max
                 |logit| (the bf16 divergence printed)
              slice 10 adds whisper-base and paligemma-3b to both: a) reduced,
                 trained on stub frame / image embeddings beside the tokens,
                 whisper's serve steps cross-attending a seeded random ``enc``;
                 b) trained 3 steps at full depth (whisper 8 x 448 + 1500
                 frames, paligemma 2 x (256 image + 256 text)) and served
                 (B 8 / B 4 at 6 layers, 32 + 32), decode held against forward in the
                 dense family's bf16 band (paligemma against its text-only
                 twin, whisper against a forward with zero encoder output)
 11. resnet   slice 10, the paper's ResNet through the PS / MPI modes:
              a) [resnet:small] the example's ResNet (stage sizes (1, 1),
                 width 8, 8 px), the six modes of algorithms.run and
                 mpi-ESGD over the int8 PS wire, card against CPU from the
                 same seed: the clock equal, losses rtol 1e-4, accuracy
                 within one test sample (1/256)
              b) [resnet] the paper-scale layout (ResNet-34's stages under
                 the reference's GN block, 224 px, 1000 classes; 21,788,200
                 f32 params) through mpi-ESGD, 4 workers in 2 clients, B 8
                 per worker, 8 completions, 4 exchanges, over the int8 and
                 then the f32 PS wire: launch counts, every sgd launch and
                 the PS-tier kernels held on the run's own operands, PS wire
                 bytes against the cost model, the center's eval loss on 64
                 held-out images below its start, a completion's split,
                 peak memory, device busy, the prototypes' host seconds
 12. net      slice 11, the socket PS tier (net/) over TCP on 127.0.0.1,
              threads of this process, ephemeral ports:
              a) [net:small] logreg8 through run_worker threads (2 workers)
                 against a port rendezvous + KVServer, dist_sgd f32 / int8
                 and dist_esgd f32 / bf16 (its exchanges ordered as the
                 in-process engine's), card against CPU: losses and
                 metrics within rtol 1e-4, exit records, degraded / late
                 counts and live sets equal, bytes per push == the cost
                 model, launches == steps (and exchanges)
              b) [net] the paper-scale ResNet, 2 worker threads x 16
                 images, the KVServer holding the center on the card:
                 dist_esgd over int8 then f32 (4 steps, an exchange every
                 step) and dist_sgd at f32 (3 steps) — launch counts, the
                 kernels held on their own operands, each dist_sgd round
                 == the plain sum of its pushes, bytes per push and reply
                 == the cost model, the loss on the trained images below
                 its start, an exchange's split, loopback TCP MB/s, step
                 and exchange ms, peak memory, device busy
 13. launch   slice 12, the launch tier, each sub-phase's wall time printed:
              a) [launch:small] launch/run_local.run_job on logreg8, 2 worker
                 processes + 1 server process spawned from the launcher's
                 scripts under the supervisor, TCP on 127.0.0.1: the card's
                 compute mode and a fresh process's start-up time; dist_sgd
                 (3 steps) as card processes (their pids seen holding the
                 card; this job alone, the next five side by side) == the
                 same job as loopback threads on the card, and
                 as CPU processes within rtol 1e-4; a worker killed and
                 respawned, and the server killed and restored, each ==
                 the clean job (exit history [137, 0], 0 degraded, restored
                 step >= 1); dist_esgd over the int8 wire (2 epochs of 2
                 steps): exit codes 0, 4 exchanges a worker, every push and
                 reply cost_model.ps_wire_nbytes long, finite losses
              b) [launch] the launcher's main with --policy auto emits a
                 pure-MPI qwen2-0.5b job (8 workers, 1 client: ranked at
                 p = 8); one rank of client_0.sh's command, with --full-size
                 --steps 3, runs through launch.train.main here: the table
                 and the chosen policy printed and named by the run's
                 header, losses finite and falling, sgd_momentum_flat
                 launches == 3 and held on one more step's operands, step
                 ms, peak memory; the card's bf16 GEMM rate (8192^3) and
                 stream rate (phase 2's sgd_momentum_flat) beside
                 launch/analysis's data-sheet constants
 14. mesh     slice 13, the shard driver over a process mesh (launch/mesh.py:
              one process per rank, torch.distributed; gloo ranks share the
              card, card tensors staged through pinned host memory), each
              sub-phase's wall time printed:
              a) [mesh:small] the reduced model, 3 steps a case, each layout
                 one spawn of gloo ranks on the card (the two side by side):
                 p = 4 and (2, 2) mpi_sgd with sgd, adamw, adagrad at f32;
                 p = 4 over the int8 and the bf16 wire and with overlap;
                 (2, 2) mpi_esgd over int8, and
                 (2, 2) mpi_esgd adamw through drive(mesh=) itself against
                 drive(p=) — each held against the emulated driver on the
                 card from the same weights and batches (state and metrics
                 ==, bit for bit), the launch counts per rank (the optimizer kernel once a step,
                 elastic_client_diff_flat / elastic_center_flat once an
                 exchange), each rank's last launch of each kernel held
                 against its plain version on its own operands, the wire
                 bytes per rank == emulated == the cost model, every rank
                 holding /dev/nvidia*; then one NCCL rank (p = 1) == the
                 emulated p = 1 step
              b) [mesh] full-width qwen2-0.5b (8 of 24 layers), 4 gloo ranks,
                 momentum SGD over the int8 then the f32 wire, 3 steps each on
                 [overlap]'s batches without overlap: losses falling and
                 within rtol 1e-6 of that run's, sgd_momentum_flat once a step
                 per rank on the (123,536,896,) f32 shard and its last launch
                 held against plain, wire bytes == the cost model; per rank
                 step ms and its split (grad fn, reduce-scatter and allgather
                 with their staged D2H / H2D and send / receive, kernel),
                 staged bytes, peak memory and the card's used MiB
 15. gspmd    slice 14, the GSPMD path: make_train_state(mesh=) /
              make_train_step(mesh) on DTensor state over gloo ranks sharing
              the card (every DTensor collective staged through pinned host
              memory), per-leaf updates, none of the 14 kernels (their launch
              counts, set to 0 in each rank before its steps, printed as 0).
              First the correctness runs, all side by side (their wall times
              are no measurement):
              a) [gspmd:small] the reduced model, 3 steps a case, one spawn
                 a layout: (data 2, model 2) mpi_sgd with sgd, adamw,
                 adagrad, fsdp=True and seq_shard_activations=True; (pod 2,
                 data 1, model 2) mpi_esgd C = 2 — each held against the
                 one-process per-leaf step on the card (losses and the
                 gathered state within rtol 1e-5)
              c) [multidevice] python -m repro_torch.launch.multidevice_train
                 --steps 4: 8 ranks (pod 2, data 2, model 2), the reduced
                 model, mpi-ESGD; the loss falls, the consensus line printed
              d) a) [gspmd:families] the CPU tests' reduced cases (f32; the
                 rank workers of tests/_torch_gspmd_families.py), three
                 worlds — 8 ranks for qwen2-moe-a2.7b and mixtral-8x7b on
                 (data 2, expert 2, tp 2); 4 for mamba2-130m, zamba2-1.2b
                 and qwen2-0.5b's caches on (data 2, model 2) / (data 1,
                 model 4); 4 for whisper-base, paligemma-3b, qwen2.5-3b,
                 qwen3-4b and phi3-medium-14b on (data 2, model 2) and
                 qwen2.5-3b on (data 1, model 4): 3 steps (losses, metrics,
                 the state after steps 1 and 3), a prefill (logits, the
                 MoE's slots and keeps of each rank's rows) and a 4 + 4
                 token decode (logits, greedy tokens, cache) each within
                 rtol 1e-5 of the one-process run on the card (zamba2's
                 state within 1e-4 / 1e-2 of a leaf's scale after steps 1 /
                 3); each world's rank 0 prints its seconds a run
              Then the full-width runs, in one spawn of 4 ranks, each on its
              own layout of it, then each in one process:
              b) [gspmd] qwen2-0.5b at 8 of 24 layers, (data 2, model 2), 3
                 momentum-SGD steps of 4 x 512: losses within rtol 1e-4 of
                 the one-process per-leaf step; per rank step ms split into
                 forward + backward (with the tensor-parallel collectives),
                 the gradient redistribute and the update, bytes staged a
                 step, peak memory, the card's used MiB
              d) b) [gspmd:families] qwen2-moe-a2.7b (bf16, 2 of 24 layers,
                 (data 2, expert 2, tp 1), 3 steps of 4 x 512), mixtral-8x7b
                 (bf16, 2 of 32, (data 1, expert 2, tp 2), decode only),
                 mamba2-130m (f32, 8 of 24, 4 x 512), zamba2-1.2b (f32, 6
                 of 38, 2 x 512), each decoding B 4, 2 + 2 tokens, and
                 qwen2-0.5b (bf16, 8 of 24, (data 1, model 4),
                 sequence-sharded cache) decoding 4 + 4;
                 c) whisper-base (6 + 6) and paligemma-3b (2 of 18) trained
                 3 steps, qwen2.5-3b, qwen3-4b (2 of 36) on (data 2, model 2)
                 and phi3-medium-14b (2 of 40) on (data 1, model 4), all
                 bf16, prefilled (the last 8 positions' logits within 4 % of
                 max |logit|) and decoding B 4, 4 + 4 tokens. Losses within
                 rtol 1e-3 of one process, the MoE's differing routes
                 counted, greedy tokens equal wherever the one-process top-2
                 margin exceeds twice the logit band over the prompt; per
                 rank step ms and its split, ms a token, bytes staged a
                 step, a prefill and a token by collective, peak memory and
                 the card's used MiB
              e) [dryrun] slice 18: one CPU subprocess (no card, no
                 kernel; at the lowest priority, so the ranks keep the
                 cores; started with the correctness block, read after
                 the full-width spawn) runs launch/dryrun's CLI on a fake
                 256-rank pod (qwen2-0.5b train_4k without the
                 extrapolation, and long_500k, which
                 the skip rule keeps out; both exit 0), then traces on
                 fake worlds of 4, at each case's config, depth, dtype,
                 batch and mesh, [gspmd]'s step, c)'s two training steps
                 and all five c) prefills and decode tokens: each traced
                 collective, as staged bytes by op, == rank 0's
                 LinkStats.by_op in every measured step, prefill and
                 token; the traced argument + temp bytes of a step
                 printed beside the rank's measured peak
 16. remat    slice 15, each sub-phase's wall time printed, then the whole
              smoke's:
              a) [remat] full-width qwen2-0.5b (8 of its 24 layers), one
                 sequence of 4096 tokens,
                 momentum SGD on the main path: 3 steps with remat=True and
                 3 with remat=False in turns from the same weights and
                 batches — losses (within rtol 1e-3 of each other, and
                 whether ==), the updated params' max abs difference, each
                 step's peak memory beside what was resident as it began
                 (the remat peak must be below the other), the median
                 steady step of each; sgd_momentum_flat once a step (6,
                 added to its row), held on one more step's operands
              b) [examples] the main() of repro_torch.launch.quickstart
                 (--steps 6), .esgd_multipod (--steps 8 --interval 4, both
                 drivers) and .serve_batched, on the card: each ran on
                 cuda, its losses fell, its tokens lie in the model's
                 vocab, the served rate names the card

Phase 2 also holds and times the PS tier's four kernels (quantize_wire,
dequantize_wire, elastic_client_flat, elastic_server_flat) at the packed
full-width buffer, n = 494,147,584, and slice 4's four (group_reduce_flat
and the QBLOCK codec over the whole 14-leaf tree, elastic_exchange_flat
on the packed buffer). The two dequantizers are timed in turns with
their one-call yardstick, ``torch.mul(codes.view(nb, B), scales.view(nb,
1))``, held equal to the plain version first. The CUDA C++
elastic_center_flat is held ``==`` its plain version at the (2, 2)
driver's full-width shards (f32 and bf16 c) and, in phase 5, on each
(2, 2) run's own exchange operands. Slice 19's per-hop int8 codec (CUDA
C++ wire_encode, wire_decode, wire_decode_add_encode) is held ``==`` its
plain version at the p = 4 int8 driver's hop shapes (4 x chunk; the
allgather's strided per-ring shard) and on the edge (ragged and strided
rows, bf16 local, the all-zero / tie / huge-among-tiny buckets), and
timed in turns against it; phase 5 times that driver's int8 gradient
legs in turns against the f32 wire's and the plain codec's.

Prints a ``kernels`` JSON line, the card line, and last the ok line. A
row's ``launches`` are its main path's (the slice-1 steps, the [ps] int8
run, ...) plus, for the rows slice 10 launches, the [resnet] int8 run's
(sgd_momentum_flat 8, quantize_wire / dequantize_wire / elastic_client_flat
/ elastic_server_flat 4 each) and 3 sgd_momentum_flat steps for each of
whisper-base and paligemma-3b, slice 11's [net] dist_esgd int8 run
(sgd_momentum_flat, elastic_client_flat, elastic_server_flat 8 each), and
slice 12's full-width [launch] run (sgd_momentum_flat 3) and slice 13's
[mesh] runs, counted in each rank and returned (sgd_momentum_flat 4 ranks x
3 steps x 2 runs). The per-hop codec's rows count the int8 runs of
[esgd] (the (2, 2) and p = 4 drivers), [overlap] (with and without
overlap), [resnet] and [net] (``HOP_RUNS``), each held exactly to its
schedule's count; every f32 run of those phases must launch none. The launches of [launch:small]'s child processes
happen in other processes and are not counted here.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the port itself: fails here (exit 1) outside a checkout of the repo
from repro_torch.checkpoint.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, TrainSettings, get_config, reduced  # noqa: E402
from repro_torch.core import algorithms as alg, cost_model, flatbuf  # noqa: E402
from repro_torch.core import collectives as collectives_mod  # noqa: E402
from repro_torch.core.collectives import WireMeter  # noqa: E402
from repro_torch.core.comm import CollectivePolicy, sync_comms  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.core.kvstore import KVStore  # noqa: E402
from repro_torch.core.sync_engine import make_sync_engine  # noqa: E402
from repro_torch.configs.resnet50_cifar import ResNetConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, ImagePipeline, TokenPipeline  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.fused_elastic import fused_elastic as fe  # noqa: E402
from repro_torch.kernels.fused_optim import fused_optim as fo  # noqa: E402
from repro_torch.kernels.fused_sgd import fused_sgd as fs  # noqa: E402
from repro_torch.kernels.quant_bucket import ops as qops, quant_bucket as qb  # noqa: E402
from repro_torch.kernels.tensor_reduce import tensor_reduce as tr  # noqa: E402
from repro_torch.kernels.timing import interleaved_ms, spread  # noqa: E402
from repro_torch.core import elastic as elastic_mod  # noqa: E402
from repro_torch.core.elastic import elastic_exchange_packed  # noqa: E402
from repro_torch.core.comm import Communicator, from_sync  # noqa: E402
from repro_torch.launch import hybrid_ps_mpi as hyb, shard_driver as sd, train as train_mod  # noqa: E402
from repro_torch.launch import analysis, autotune, launcher, run_local  # noqa: E402
from repro_torch.launch.serve import BatchedServer, make_serve_step  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    grad_spec, make_grad_fn, make_overlap_grad_fn, make_train_state, make_train_step,
    overlap_schedule, stacked_grads)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.core import kvstore as kvstore_mod  # noqa: E402
from repro_torch.net import (kvserver as net_kvserver, problem as net_problem,  # noqa: E402
                             remote_kv as net_remote, rendezvous as net_rdzv,
                             transport as net_transport, wire as net_wire,
                             worker as net_worker)
from repro_torch.models.resnet import _block_plan, init_resnet, resnet_loss  # noqa: E402
from repro_torch.optim import sgd as sgd_mod  # noqa: E402
from repro_torch.optim.sgd import flat_hp, sgd as sgd_optimizer  # noqa: E402
from repro_torch.sharding.rules import distribute, param_specs  # noqa: E402
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
#: slice 19's per-hop int8 codec (CUDA C++; it replaces no Pallas kernel:
#: the reference's inline ``jnp`` codec, which XLA fuses into each hop),
#: every output held ``==`` its plain version. Its launches stay out of
#: ALL_KERNELS' per-run counts: ``_hop_launches`` holds them exactly per run
#: (``_hop_want``) and the int8 runs the kernels line counts are kept in
#: ``HOP_RUNS``
HOP_KERNELS = {
    "wire_encode": dict(
        wrapper=qb.wire_encode, plain=qb.wire_encode_plain,
        source="src/repro_torch/csrc/wire_hop.cu", route="cuda",
        replaces="src/repro/kernels/quant_bucket/quant_bucket.py:114",
        flops_per_elem=5),
    "wire_decode": dict(
        wrapper=qb.wire_decode, plain=qb.wire_decode_plain,
        source="src/repro_torch/csrc/wire_hop.cu", route="cuda",
        replaces="src/repro/kernels/quant_bucket/quant_bucket.py:137",
        flops_per_elem=1),
    "wire_decode_add_encode": dict(
        wrapper=qb.wire_decode_add_encode, plain=qb.wire_decode_add_encode_plain,
        source="src/repro_torch/csrc/wire_hop.cu", route="cuda",
        replaces="src/repro/core/collectives.py:181",
        flops_per_elem=7),
}
#: label -> the per-hop launches of each int8 run the kernels line counts
HOP_RUNS: dict = {}
#: the full-width qwen2-0.5b of the slice, [esgd], [ps], [faults],
#: [overlap], [mesh] and [remat]: 8 of its 24 layers (cut to keep the smoke
#: in its time; phase 2's kernels and the serve phases keep all 24)
RUN_DEPTH = 8
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
#: slice 7's full-width runs: 4 schedule buckets ([embed] + 2 layer slices
#: + [head]); the p = 4 driver takes 4 momentum-SGD steps of 2 x 512 per
#: device, the p = 1 train step 3 AdamW steps of 8 x 512
OVERLAP_BUCKETS = 4
OVERLAP_STEPS = 4
OVERLAP_ADAMW_STEPS = 3
#: the full-width schedule's issue-order share at p = 4
#: (cost_model.overlap_fraction of the bucket bytes) at RUN_DEPTH layers
OVERLAP_SHARE_P4 = 0.4668376342362558


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for k in (*ALL_KERNELS.values(), *HOP_KERNELS.values()):
        k["wrapper"].launches = 0


def counts(kernels=KERNELS) -> dict:
    return {name: k["wrapper"].launches for name, k in kernels.items()}


def _hop_want(p: int, rings: int, rs: int, ag: "int | None" = None) -> dict:
    """The per-hop launches of ``rs`` int8 reduce-scatters and ``ag``
    (default ``rs``) allgathers over ``p`` ranks in ``rings`` rings: a
    reduce-scatter encodes once a ring and fuses each of its p - 1 hops; an
    allgather encodes once a ring and decodes the owner's shard and each of
    its p - 1 hops."""
    ag = rs if ag is None else ag
    return {"wire_encode": (rs + ag) * rings, "wire_decode": ag * p * rings,
            "wire_decode_add_encode": rs * (p - 1) * rings}


def _hop_launches(label, want=None) -> dict:
    """The per-hop kernels' launches since the last ``reset_counts``,
    held exactly: an int8 run the kernels line counts must have launched
    ``want`` (kept in ``HOP_RUNS``); any other run, none."""
    got = counts(HOP_KERNELS)
    expect = want or dict.fromkeys(HOP_KERNELS, 0)
    if got != expect:
        raise AssertionError(f"{label}: per-hop launches {got}, want {expect}")
    if want:
        HOP_RUNS[label] = got
    return got


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
    fused_elastic.cu equation named (``(Eq)2`` -> ``center``) and the
    wire_hop.cu mode (``(Mode)2`` -> ``hop``)."""
    name = demangled.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    name = re.sub(r"\(Mode\)(\d)",
                  lambda m: ("encode", "decode", "hop", "last")[int(m[1])], name)
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


def _run_cfg():
    """Full-width qwen2-0.5b at ``RUN_DEPTH`` layers."""
    return dataclasses.replace(get_config("qwen2-0.5b"), num_layers=RUN_DEPTH)


def phase_slice(dev) -> tuple[dict, dict, object]:
    cfg = _run_cfg()
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


class _PlainCodec:
    """The rings' per-hop codec (``core.collectives``' names) swapped for
    its plain versions, to time the int8 legs as they ran before the hop
    kernels: the same hops in the same order, the same results."""

    NAMES = ("wire_encode", "wire_decode", "wire_decode_add_encode")

    def __enter__(self):
        self._orig = {name: getattr(collectives_mod, name) for name in self.NAMES}
        for name in self.NAMES:
            setattr(collectives_mod, name, getattr(qb, f"{name}_plain"))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(collectives_mod, name, fn)


def _legs_in_turns(grad_comm, g_buf, nr, label, rounds: int = 3) -> dict:
    """The gradient leg (reduce-scatter + allgather of ``g_buf``) over the
    int8 wire through the hop kernels, over the f32 wire, and over the int8
    wire through the plain codec, timed in turns on the card (``rounds``
    rounds of f32, kernels, plain, plain, kernels, f32; 2 calls a block):
    ms per leg, median [min–max]. The kernels' leg is held ``==`` the plain
    codec's first."""
    f32_comm = grad_comm.with_policy(wire_dtype=None)
    legs = lambda comm: (lambda: comm.allgather(
        comm.reduce_scatter(g_buf, num_rings=nr), num_rings=nr))
    kernels, f32 = legs(grad_comm), legs(f32_comm)

    def plain():
        with _PlainCodec():
            return kernels()

    _hold_exact(f"{label} int8 legs (kernels vs plain codec)", kernels(), plain())
    fns = {"f32": f32, "int8 kernels": kernels, "int8 plain codec": plain}
    order = ("f32", "int8 kernels", "int8 plain codec", "int8 plain codec",
             "int8 kernels", "f32")
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            times[name].append(cuda_ms(fns[name], reps=2, warmup=0))
    stats = {name: {"median": float(np.median(t)), "min": min(t), "max": max(t),
                    "blocks": len(t)} for name, t in times.items()}
    ratio = stats["int8 kernels"]["median"] / stats["f32"]["median"]
    log(f"[esgd] {label}: RS + AG legs in turns ({rounds} rounds): f32 "
        f"{spread(stats['f32'])} ms, int8 through the hop kernels "
        f"{spread(stats['int8 kernels'])} ms (x{ratio:.3f} of f32), int8 through "
        f"the plain codec {spread(stats['int8 plain codec'])} ms; the kernels' legs "
        f"== the plain codec's")
    return stats


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
        if grad_comm.wire == "int8" and p == 4:
            out["collectives_turns_ms"] = _legs_in_turns(grad_comm, g_buf, nr, label)
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


def _step_profile(step, state, batch, top: int = 0) -> dict:
    """One more step under ``torch.profiler``: the device ms summed over
    the kernels and copies on the card (None when the trace shows no
    device time), the wall ms with the profiler on, the busy share of
    that wall clock (which the profiler lengthens), and the ``top`` device
    kernels by summed time as (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the trace's device events read as they come: building the profiler's
    # per-op tables (``key_averages``) for a full-width step of ~10^5 ops
    # takes tens of seconds; the device events alone give the same sums
    per_name, busy_ns = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        busy_ns += e.duration_ns()
        ns, n = per_name.get(e.name(), (0, 0))
        per_name[e.name()] = (ns + e.duration_ns(), n + 1)
    busy_ms = busy_ns / 1e6
    rows = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms or None,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "top_kernels_ms": [(name[:60], ns / 1e6, n) for name, (ns, n) in rows]}


def _device_busy(step, state, batch) -> tuple:
    """``_step_profile``'s (busy share, device ms, wall ms)."""
    p = _step_profile(step, state, batch)
    return p["busy_share"], p["busy_ms"], p["wall_ms"]


def _check_launches(label, got, want, steps: int = ESGD_STEPS) -> None:
    for name, c in got.items():
        if c != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {c} times in "
                                 f"{steps} steps, want {want.get(name, 0)}")


def phase_esgd(dev) -> tuple[dict, dict]:
    cfg = _run_cfg()
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
        # per-hop codec: each step's gradient legs over a client's 2
        # devices and each exchange's over the 2 clients, 2 rings each
        ("driver (2, 2) mpi_esgd int8", "driver", _esgd_sync("mpi_esgd", 2, "int8"), (2, 2),
         {"elastic_client_diff_flat": half, "elastic_center_flat": half,
          "sgd_momentum_flat": ESGD_STEPS}, _hop_want(2, 2, ESGD_STEPS + half)),
        ("driver p=4 mpi_sgd int8", "driver", _esgd_sync("mpi_sgd", 1, "int8"), 4,
         {"sgd_momentum_flat": ESGD_STEPS}, _hop_want(4, 2, ESGD_STEPS)),
    ]
    log(f"[esgd] full-width {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"{cfg.dtype}; FlatBuffer size={spec.size}; global batch 8 x 512 "
        f"(C=2: 4 x 512 per client; 4 devices: 2 x 512 per device); "
        f"momentum SGD lr {ESGD_LR}, alpha 0.5, interval 2, {ESGD_STEPS} steps")
    launches, report = {}, {}
    for label, kind, sync, p, want, *hop_want in runs:
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
        hop = _hop_launches(f"[esgd] {label}", *hop_want)
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
                         "launches": {k: v for k, v in got.items() if v},
                         "hop_launches": hop, **br}
        log(f"[esgd] {label}: losses {[round(x, 4) for x in losses]} step_ms "
            f"{[round(x, 2) for x in step_ms]} peak_mem {peak / 2**30:.2f} GiB "
            f"launches {report[label]['launches']} per-hop codec {hop} "
            f"wire bytes/step {wire} "
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
    cfg_model = _run_cfg()
    model = build_model(cfg_model)
    spec = grad_spec(model)
    grad = _grad_loss_only(make_grad_fn(model))
    data = dict(seed=0, vocab_size=256, seq_len=512, batch_size=2,
                steps_per_epoch=PS_ITERS, num_shards=PS_RUN["num_workers"])
    held = TokenPipeline(DataConfig(**dict(data, shard=99)), device=dev).batch_at(0, 0)
    evaluate = _eval_fn(model, held)
    log(f"[ps] full-width {cfg_model.name} {cfg_model.dtype}, {cfg_model.num_layers} of "
        f"24 layers: FlatBuffer payload="
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
# phase 2 (slice 19): the per-hop int8 codec at the p = 4 driver's ring hops
# ---------------------------------------------------------------------------

def _hop_geometry() -> tuple[int, int, int]:
    """(padded buffer length, rings, chunk) of the p = 4 int8 driver's
    gradient rings at RUN_DEPTH layers: each hop moves a (4, chunk) stack,
    and the allgather encodes a (4, rings · chunk) shard ring by ring."""
    spec = grad_spec(build_model(_run_cfg()))
    sync = _esgd_sync("mpi_sgd", 1, "int8")
    grad_comm, _ = sync_comms(sync, sd.driver_world(sync, 4))
    nr = grad_comm.rings_for(spec.nbytes)
    _, total = flatbuf.shard_geometry(spec.size, grad_comm.static_size, nr)
    return total, nr, total // (4 * nr)


def _hop_values(rows, n, dev, seed, dtype=torch.float32):
    """Normal values with the edge buckets at every row's front: all zeros,
    127 and ±k.5 (scale 1: every code a tie that rounds half to even), and
    one huge value among tiny ones."""
    x = torch.randn(rows, n, generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    edge = torch.cat([torch.zeros(128), torch.tensor([127.0]),
                      torch.arange(-63, 64) + 0.5, torch.tensor([3e4]),
                      torch.full((127,), 1e-3)]).to(dev)
    k = min(n, edge.numel())
    x[:, :k] = edge[:k]
    return x.to(dtype)


def phase_hop_kernels(dev) -> dict:
    """The per-hop codec (``csrc/wire_hop.cu``) at the p = 4 int8 driver's
    hop shapes — the reduce-scatter's first encode, its fused hops and last
    step, the allgather's strided per-ring encode and its decodes — and on
    the edge: ragged rows, strided rows, bf16 local. Every output held
    ``==`` its plain version; each entry point timed in turns against it."""
    total, nr, chunk = _hop_geometry()
    log(f"[kernels] slice 19 operands: the p = 4 int8 driver's buffer {total} "
        f"values, {nr} rings of 4 x {chunk} chunks a hop")
    x = _hop_values(4, chunk, dev, 5)
    shard = _hop_values(4, nr * chunk, dev, 6)
    local = _hop_values(4, chunk, dev, 7) * 3
    sent = qb.wire_encode_plain(_hop_values(4, chunk, dev, 8))
    cases = {       # name: (args, kwargs) of the timed main-path call
        "wire_encode": ((x,), {}),
        "wire_decode": ((*sent, chunk), {}),
        "wire_decode_add_encode": ((*sent, local, chunk), {}),
        "wire_decode_add_encode last": ((*sent, local, chunk), {"last": True}),
    }
    err = {name: 0.0 for name in HOP_KERNELS}
    for name, (args, kw) in cases.items():
        k = HOP_KERNELS[name.split()[0]]
        t0 = time.perf_counter()
        got = k["wrapper"](*args, **kw)        # the first call loads the library
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        err[name.split()[0]] = max(err[name.split()[0]],
                                   _hold_exact(name, got, k["plain"](*args, **kw)))
        outs = got if isinstance(got, tuple) else (got,)
        moved = nbytes(*(a for a in args if torch.is_tensor(a))) + nbytes(*outs)
        del got, outs
        t = interleaved_ms(lambda: k["wrapper"](*args, **kw),
                           lambda: k["plain"](*args, **kw), rounds=5, reps=5)
        library_ms, note = None, ("no library yardstick: no one PyTorch call computes "
                                  "the per-128-bucket absmax int8 encode")
        if kw.get("last"):
            note = "no library yardstick timed: the kernels line's row is the fused hop's"
        if name == "wire_decode":      # codes × scale, one bucket a row
            nb = sent[1].numel()
            mul = lambda: torch.mul(sent[0].view(nb, qb.WIRE_BLOCK), sent[1].view(nb, 1))
            _hold_yardstick(name, mul().view(4, -1)[:, :chunk], k["plain"](*args))
            _, library_ms, note = cuda_ms_pair(lambda: k["wrapper"](*args), mul)
            note += (f"; library torch.mul(codes.view({nb}, {qb.WIRE_BLOCK}), "
                     f"scales.view({nb}, 1)), held == plain")
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = k["flops_per_elem"] * 4 * chunk / F32_FLOPS_PER_S * 1e3
        log(f"[kernels] {name} (4, {chunk}) first call {first_s:.2f} s: outputs == "
            f"plain; in turns kernel {spread(t['kernel'])} ms, plain "
            f"{spread(t['library'])} ms; bytes={moved} bound_ms="
            f"{max(bytes_ms, ops_ms):.4f} ({bytes_ms / t['kernel']['median']:.1%} "
            f"of it); library_ms={library_ms} {note}")
        if name in HOP_KERNELS:
            HOP_KERNELS[name]["row"] = {
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": None, "max_abs_err": 0.0,
                "ms": t["kernel"]["median"], "plain_ms": t["library"]["median"],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms}
    # the allgather's per-ring shard, rows strided by the ring count
    view = shard.reshape(4, nr, chunk).select(-2, nr - 1)
    err["wire_encode"] = max(err["wire_encode"], _hold_exact(
        "wire_encode strided", qb.wire_encode(view), qb.wire_encode_plain(view)))
    del x, shard, local, sent, view
    torch.cuda.empty_cache()
    # the edge: ragged rows, strided rows, bf16 local, a lone row
    edges = []
    for n, rows, dtype in ((100_003, 3, torch.float32), (100_003, 3, torch.bfloat16),
                           (129, 1, torch.float32), (8192, 4, torch.bfloat16)):
        vals = _hop_values(2 * rows, n, dev, n, dtype).reshape(rows, 2, n).select(-2, 1)
        codes, scales = qb.wire_encode(vals)
        err["wire_encode"] = max(err["wire_encode"], _hold_exact(
            "wire_encode edge", (codes, scales), qb.wire_encode_plain(vals)))
        err["wire_decode"] = max(err["wire_decode"], _hold_exact(
            "wire_decode edge", qb.wire_decode(codes, scales, n),
            qb.wire_decode_plain(codes, scales, n)))
        loc = _hop_values(2 * rows, n, dev, n + 1, dtype).reshape(rows, 2, n).select(-2, 0)
        for last in (False, True):
            err["wire_decode_add_encode"] = max(err["wire_decode_add_encode"], _hold_exact(
                "wire_decode_add_encode edge",
                qb.wire_decode_add_encode(codes, scales, loc, n, last=last),
                qb.wire_decode_add_encode_plain(codes, scales, loc, n, last=last)))
        edges.append(f"({rows}, {n}) {str(dtype)[6:]} strided")
    log(f"[kernels] per-hop codec on the edge ({'; '.join(edges)}; each row's "
        f"front: an all-zero bucket, ±k.5 ties, one huge value among tiny ones): "
        f"codes, scales, values and sums == plain")
    rows = {}
    for name, e in err.items():
        rows[name] = HOP_KERNELS[name].pop("row")
        rows[name]["max_abs_err"] = e
    return rows


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
    cfg_model = _run_cfg()
    model = build_model(cfg_model)
    spec = grad_spec(model)
    grad = _grad_loss_only(make_grad_fn(model))
    data = dict(seed=0, vocab_size=256, seq_len=512, batch_size=2,
                steps_per_epoch=PS_ITERS, num_shards=PS_RUN["num_workers"])
    held = TokenPipeline(DataConfig(**dict(data, shard=99)), device=dev).batch_at(0, 0)
    log(f"[faults] full-width {cfg_model.name} {cfg_model.dtype}, {cfg_model.num_layers} "
        f"of 24 layers")
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


# ---------------------------------------------------------------------------
# phase 8: slice 7 — backward overlap
# ---------------------------------------------------------------------------

def _overlap_sync(wire=None, overlap=True) -> SyncConfig:
    return SyncConfig(mode="mpi_sgd", policy=CollectivePolicy(
        method="ring", num_rings=1, wire_dtype=wire, overlap=overlap,
        overlap_buckets=OVERLAP_BUCKETS))


def phase_overlap_small(dev) -> dict:
    """Reduced model, f32, 4 schedule buckets: 3 overlapped steps on the
    card against the same steps on the CPU, from the same weights, for
    make_train_step at p = 1 (sgd, adamw at eps 1e-5, adagrad at eps
    1e-4), the p = 4 driver (sgd; f32, bf16, int8 wire) and the (2, 2)
    driver (f32). Losses within rtol 1e-4; params rtol 1e-3 / atol 1e-5,
    over a bf16 or int8 wire the reference's band for a quantized leg
    (rtol 1e-2, atol 2e-3: a value next to a rounding boundary can take
    the neighbouring code on one device and not the other). Then the
    int8 codes and every bucket's leg at p = 4 on identical inputs, card
    == CPU. Every optimizer kernel the card runs launch is held against its
    plain version on its own operands (``_KernelHold``); returns the
    worst error per kernel."""
    model = build_model(reduced(get_config("qwen2-0.5b")))
    errs: dict = {}
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=64, batch_size=8))
    momentum_sgd = sgd_optimizer(0.1, momentum=0.9)
    runs = [("train p=1 sgd", 1, momentum_sgd, None),
            ("train p=1 adamw", 1, sgd_mod.adamw(3e-3, eps=1e-5), None),
            ("train p=1 adagrad", 1, sgd_mod.adagrad(1e-2, eps=1e-4), None)]
    runs += [(f"driver p=4 sgd {w or 'f32'}", 4, momentum_sgd, w)
             for w in (None, "bf16", "int8")]
    runs.append(("driver (2, 2) sgd f32", (2, 2), momentum_sgd, None))
    for label, p, opt, wire in runs:
        sync = _overlap_sync(wire)
        out = []
        for d in ("cpu", dev):
            if p == 1:
                state = make_train_state(model, opt, sync, device="cpu")
                step = make_train_step(model, opt, sync, device=d)
                split = lambda b: b
            else:
                state = sd.make_driver_state(model, opt, sync, p, device="cpu")
                step = sd.make_emulated_step(model, opt, sync, p)
                split = lambda b, p=p: sd.shard_batch(b, p)
            state = tree_map(lambda a: a.to(d), state)
            losses = []
            with _KernelHold() as hold:
                for i in range(3):
                    state, met = step(state, split(pipe.batch_at(0, i)))
                    losses.append(float(met["loss"]))
            out.append((losses, state))
        for name, e in hold.err.items():    # the card run's holds
            errs[name] = max(errs.get(name, 0.0), e)
        (cl, cs), (gl, gs) = out
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl),
                                   rtol=1e-4, atol=0)
        tol = (dict(rtol=1e-3, atol=1e-5) if wire is None
               else dict(rtol=1e-2, atol=2e-3))
        _close_trees(gs["params"], cs["params"], tol)
        log(f"[overlap:small] {label}: card {gl} == cpu {cl} (rtol 1e-4); "
            f"params within {tol}")
    _, sched = overlap_schedule(model, _overlap_sync("int8"), 4)
    comm = Communicator.world(("dev",), (4,), policy=CollectivePolicy(
        method="ring", wire_dtype="int8"))
    got = []
    for d in ("cpu", dev):
        got.append([])
        for b, n in enumerate(sched.sizes):
            gen = torch.Generator().manual_seed(b)
            x = torch.randn((4, n), generator=gen).to(d)
            got[-1] += [*qb.wire_encode_plain(x), comm.reduce_scatter_bucket(x, sched, b)]
    for a, b in zip(*got):
        if a.dtype != b.dtype or not torch.equal(a, b.cpu()):
            raise AssertionError("[overlap:small] int8 codes / bucket legs: "
                                 "card != cpu on identical inputs")
    log(f"[overlap:small] int8 wire at p = 4, buckets {sched.sizes}: the plain "
        f"codec's codes and scales and every bucket's reduce-scatter leg (the "
        f"per-hop kernels on the card) card == cpu; kernel "
        f"holds on the card runs' operands: max_abs_err {errs}")
    return errs


class _IssueLog:
    """The overlapped step's issue order: each stage backward
    (``launch.train.stage_backward``, with the bytes metered before it)
    and each bucket leg (``Communicator.reduce_scatter_bucket``, with its
    bytes), as tests/test_torch_overlap.py reads it."""

    def __init__(self, meter: WireMeter):
        self.meter, self.events = meter, []
        self._bwd = train_mod.stage_backward
        self._rs = Communicator.reduce_scatter_bucket

    def __enter__(self):
        meter, events, bwd, rs = self.meter, self.events, self._bwd, self._rs

        def logged_bwd(s, *args):
            events.append(("bwd", s, meter.bytes))
            return bwd(s, *args)

        def logged_rs(comm, seg, schedule, b):
            before = meter.bytes
            out = rs(comm, seg, schedule, b)
            events.append(("rs", b, meter.bytes - before))
            return out

        train_mod.stage_backward = logged_bwd
        Communicator.reduce_scatter_bucket = logged_rs
        return self

    def __exit__(self, *exc):
        train_mod.stage_backward = self._bwd
        Communicator.reduce_scatter_bucket = self._rs

    def step_share(self, num_buckets: int) -> float:
        """Check one step's order (stage s's backward, then bucket s's
        leg, head first) and return the share of reduce-scatter bytes
        metered before the embedding stage's backward."""
        want = [ev for s in range(num_buckets - 1, -1, -1)
                for ev in (("bwd", s), ("rs", s))]
        if [e[:2] for e in self.events] != want:
            raise AssertionError(f"[overlap] issue order {self.events}")
        legs = {e[1]: e[2] for e in self.events if e[0] == "rs"}
        total = sum(legs.values())
        # 1 - (bytes issued at or after the embedding stage's backward)
        # / total: the cost model's form of the same share
        share = 1.0 - legs[0] / total if total else 0.0
        self.events.clear()
        return share


class _KernelHold:
    """Wraps the optimizer kernels as ``optim.sgd`` launches them, for one
    step: each launch's outputs held against the plain version on the
    operands the path gave it, at phase 2's tolerances (1-D streams in
    2^26-element pieces, AdamW row by row: the plain version's f32
    temporaries for the whole buffer would not fit beside the run)."""

    PIECE = 1 << 26

    def __init__(self):
        self.err, self.calls = {}, []
        self._orig = {name: getattr(sgd_mod, name) for name in KERNELS}
        self._lock = threading.Lock()   # [net]'s worker threads share it

    def _wrap(self, name, orig):
        k = KERNELS[name]

        def call(p, s, g, hp):
            out = orig(p, s, g, hp)
            if name == "adamw_flat":
                rows = p.shape[0] if p.dim() == 2 else 1
                view = lambda t, *shape: t.reshape(rows, *shape)
                pieces = [(view(p, -1)[i], view(s, 2, -1)[i], view(g, -1)[i],
                           view(out[0], -1)[i], view(out[1], 2, -1)[i])
                          for i in range(rows)]
            else:
                pieces = [tuple(t[i:i + self.PIECE] for t in (p, s, g, *out))
                          for i in range(0, p.numel(), self.PIECE)]
            err = 0.0
            for pp, ss, gg, op, os_ in pieces:
                for got, want in zip((op, os_), k["plain"](pp, ss, gg, hp)):
                    torch.testing.assert_close(got, want, rtol=k["rtol"],
                                               atol=k["atol"])
                    err = max(err, float((got.float() - want.float()).abs().max()))
            with self._lock:
                self.err[name] = max(self.err.get(name, 0.0), err)
                self.calls.append(f"{name} on {tuple(p.shape)} {str(p.dtype)[6:]}")
            return out

        return call

    def __enter__(self):
        for name, orig in self._orig.items():
            setattr(sgd_mod, name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(sgd_mod, name, orig)


def _overlap_split(model, opt, sync, p, state, batch) -> dict:
    """One overlapped step's pieces, each timed alone: the staged grad fn
    (every device's forward + staged backward with the bucket legs issued
    inside it), the bucket legs alone, the update leg (pack, shard
    select, ONE kernel, the trailing allgather, unpack), the kernel
    alone and the allgather alone. Staged forward + backward is the grad
    fn less the legs. Then the gradient half of the step in its two
    forms, timed in turns (``interleaved_ms``, one round of one call a
    block, cut from 3 rounds of 2 to pay for phase 15's
    [gspmd:families]): the staged grad fn against the monolithic one (every
    device's forward + backward, pack, and the one reduce-scatter at the
    same ring count)."""
    shape = sd._factorize(p)[0] if p != 1 else ()
    comm = sd.driver_world(sync, p) if p != 1 else from_sync(sync)
    stages, sched = overlap_schedule(model, sync, comm.static_size)
    device = tree_leaves(state["params"])[0].device
    to_world = lambda t: t.reshape(shape + tuple(t.shape[1:])) if shape else t
    params, opt_state = tree_map(to_world, state["params"]), tree_map(to_world, state["opt"])
    wbatch = {k: to_world(v.to(device)) for k, v in batch.items()}
    gfn = make_overlap_grad_fn(model, stages, sched, comm)
    out = {"grad_fn_ms": cuda_ms(lambda: gfn(params, wbatch), reps=2, warmup=1)}
    if comm.static_size > 1:
        segs = [torch.ones(shape + (n,), device=device) for n in sched.sizes]
        out["bucket_legs_ms"] = cuda_ms(lambda: [
            comm.reduce_scatter_bucket(seg, sched, b) for b, seg in enumerate(segs)],
            reps=2, warmup=1)
        del segs
    else:
        out["bucket_legs_ms"] = 0.0
    out["staged_fwd_bwd_ms"] = out["grad_fn_ms"] - out["bucket_legs_ms"]
    _, _, g_shard = gfn(params, wbatch)
    engine = make_sync_engine(opt, sync, comm=comm, spec=grad_spec(model),
                              schedule=sched)
    staged = stages.stage(params, len(shape))
    out["update_leg_ms"] = cuda_ms(lambda: engine.update_overlapped(
        g_shard, staged, opt_state), reps=2, warmup=1)
    p_shard = comm.shard_select_sched(sched.spec.pack(staged), sched)
    hp = flat_hp(opt.hyper, device)
    name = sgd_mod._flat_name(opt.hyper)
    out["kernel_ms"] = cuda_ms(lambda: sgd_mod._fused_shard_update(
        name, hp, p_shard, opt_state, g_shard), reps=5)
    out["allgather_ms"] = (cuda_ms(lambda: comm.allgather_sched(p_shard, sched),
                                   reps=2, warmup=1)
                           if comm.static_size > 1 else 0.0)
    del g_shard, p_shard, staged
    spec = grad_spec(model)
    grad_fn = make_grad_fn(model)
    _, total = flatbuf.shard_geometry(spec.size, comm.static_size, 1)

    def monolithic():
        if shape:
            grads = stacked_grads(grad_fn, params, wbatch, len(shape))[2]
        else:
            grads = grad_fn(params, wbatch)[2]
        buf = flatbuf.pack_padded(spec, grads, total)
        del grads
        return comm.reduce_scatter(buf, num_rings=1) if shape else buf

    turns = interleaved_ms(lambda: gfn(params, wbatch), monolithic,
                           rounds=1, reps=1, warmup=1)
    out["grad_half_staged_ms"] = turns["kernel"]
    out["grad_half_monolithic_ms"] = turns["library"]
    return out


def _overlap_hop_want(sync, p, steps) -> "dict | None":
    """The per-hop launches of an int8 run of ``steps`` steps: a
    single-ring reduce-scatter a schedule bucket (one a step without
    overlap) and one single-ring allgather a step."""
    if sync.policy.wire_dtype != "int8":
        return None
    buckets = OVERLAP_BUCKETS if sync.overlap else 1
    return _hop_want(p, 1, buckets * steps, steps)


def _overlap_run(label, model, opt, sync, p, batches, want) -> dict:
    """One full-width run of ``len(batches)`` steps: the launch counts set
    to 0 just before and read just after; the per-step wire bytes and the
    issue-order share checked on every step."""
    dev = batches[0]["tokens"].device
    meter = WireMeter()
    if p == 1:
        state = make_train_state(model, opt, sync, device=dev)
        step = make_train_step(model, opt, sync, device=dev)
        split = lambda b: b
    else:
        state = sd.make_driver_state(model, opt, sync, p, device=dev)
        step = sd.make_emulated_step(model, opt, sync, p, meter=meter)
        split = lambda b: sd.shard_batch(b, p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, wire, shares = [], [], [], []
    with _IssueLog(meter) as issue:
        reset_counts()
        for batch in batches:
            meter.reset()
            t0 = time.perf_counter()
            state, met = step(state, split(batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
            wire.append(meter.bytes)
            if sync.overlap:
                shares.append(issue.step_share(OVERLAP_BUCKETS))
        got = counts(ALL_KERNELS)
    hop = _hop_launches(f"[overlap] {label}", _overlap_hop_want(sync, p, len(batches)))
    peak = torch.cuda.max_memory_allocated()
    _check_launches(label, got, want, len(batches))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall {losses}")
    rec = {"losses": losses, "step_ms": step_ms, "peak_mem_bytes": peak,
           "wire_bytes_per_step": wire, "issue_share_per_step": shares,
           "launches": {k: v for k, v in got.items() if v}, "hop_launches": hop}
    if sync.overlap:
        with _KernelHold() as hold:       # one more step, not timed
            step(state, split(batches[0]))
        rec["hold_max_abs_err"] = hold.err
        rec["split"] = _overlap_split(model, opt, sync, p, state, split(batches[0]))
        share, busy_ms, wall_ms = _device_busy(step, state, split(batches[0]))
        rec["split"].update(device_busy_share=share, device_busy_ms=busy_ms,
                            profiled_step_ms=wall_ms)
        log(f"[overlap] {label}: kernel hold ({'; '.join(hold.calls)}) == plain "
            f"within phase 2's tolerances: max_abs_err {hold.err}")
        log(f"[overlap] {label}: gradient half in turns: staged (legs inside) "
            f"{spread(rec['split']['grad_half_staged_ms'])} ms against monolithic "
            f"(+ pack + one reduce-scatter) "
            f"{spread(rec['split']['grad_half_monolithic_ms'])} ms")
    del state, step
    torch.cuda.empty_cache()
    return rec


def phase_overlap(dev) -> tuple[dict, dict, dict]:
    cfg = _run_cfg()
    model = build_model(cfg)
    p = 4
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=512,
                                    batch_size=8), device=dev)
    batches = [pipe.batch_at(0, i) for i in range(OVERLAP_STEPS)]
    stages, sched = overlap_schedule(model, _overlap_sync(), p)
    share_model = cost_model.overlap_fraction([n * 4 for n in sched.sizes], p)
    if share_model != OVERLAP_SHARE_P4:
        raise AssertionError(f"[overlap] modeled share {share_model}")
    log(f"[overlap] full-width {cfg.name} {cfg.dtype}, {cfg.num_layers} of 24 layers: "
        f"{stages.num_stages} stages, staged spec size {sched.spec.size}, "
        f"buckets {sched.sizes}, p = {p} chunks {sched.chunks}, shard "
        f"{sched.shard_size}; global batch 8 x 512 (2 x 512 per device); "
        f"momentum SGD lr {ESGD_LR}, {OVERLAP_STEPS} steps")
    report, errs = {}, {}
    sgd_want = {"sgd_momentum_flat": OVERLAP_STEPS}
    for wire in (None, "int8"):
        tag = wire or "f32"
        mono = _overlap_run(f"driver p=4 {tag} without overlap", model,
                            sgd_optimizer(ESGD_LR, momentum=0.9),
                            _overlap_sync(wire, overlap=False), p, batches, sgd_want)
        label = f"driver p=4 {tag} overlap"
        rec = _overlap_run(label, model, sgd_optimizer(ESGD_LR, momentum=0.9),
                           _overlap_sync(wire), p, batches, sgd_want)
        legs = [cost_model.grad_leg_bytes(sched.bucket_padded(b) * 4, p, wire)
                for b in range(sched.num_buckets)]
        gather = cost_model.param_leg_bytes(p * sched.shard_size * 4, p, wire)
        want_bytes = sum(legs) + gather
        mono_bytes = _wire_per_step(grad_spec(model), _overlap_sync(wire, overlap=False),
                                    p)[0]
        if any(b != want_bytes for b in rec["wire_bytes_per_step"]):
            raise AssertionError(f"{label}: wire bytes {rec['wire_bytes_per_step']}, "
                                 f"cost model {want_bytes}")
        if any(b != mono_bytes for b in mono["wire_bytes_per_step"]):
            raise AssertionError(f"{label} without overlap: wire bytes "
                                 f"{mono['wire_bytes_per_step']}, cost model {mono_bytes}")
        if any(x != share_model for x in rec["issue_share_per_step"]):
            raise AssertionError(f"{label}: issue-order share "
                                 f"{rec['issue_share_per_step']} != {share_model}")
        band = 1e-6 if wire is None else 2e-3      # tests/test_overlap.py _band
        rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], mono["losses"])]
        if max(rel) > band:
            raise AssertionError(f"{label}: losses {rec['losses']} vs without "
                                 f"overlap {mono['losses']}: rel {rel} > {band}")
        rec.update(cost_model_bytes=want_bytes, cost_model_legs=legs,
                   cost_model_allgather=gather, monolithic_bytes=mono_bytes,
                   padding_bytes=want_bytes - mono_bytes, loss_rel_vs_monolithic=rel,
                   monolithic=mono)
        report[label] = rec
        errs["sgd_momentum_flat"] = max(errs.get("sgd_momentum_flat", 0.0),
                                        rec["hold_max_abs_err"]["sgd_momentum_flat"])
        br = rec["split"]
        log(f"[overlap] {label}: losses {[round(x, 4) for x in rec['losses']]} "
            f"(without overlap {[round(x, 4) for x in mono['losses']]}, max rel "
            f"{max(rel):.3e} <= {band}); step_ms {[round(x, 1) for x in rec['step_ms']]} "
            f"(without overlap {[round(x, 1) for x in mono['step_ms']]}); peak_mem "
            f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB (without "
            f"{mono['peak_mem_bytes'] / 2**30:.2f}); launches {rec['launches']}")
        log(f"[overlap] {label}: wire bytes/step {rec['wire_bytes_per_step']} == "
            f"cost model legs {legs} + allgather {gather:.0f} = {want_bytes:.0f}; "
            f"without overlap {mono_bytes:.0f} (per-bucket padding "
            f"{want_bytes - mono_bytes:.0f} B); issue-order share "
            f"{rec['issue_share_per_step'][0]!r} == overlap_fraction {share_model!r}")
        log(f"[overlap] {label} split: staged grad fn {br['grad_fn_ms']:.2f} ms "
            f"(staged fwd+bwd {br['staged_fwd_bwd_ms']:.2f} + bucket legs "
            f"{br['bucket_legs_ms']:.2f}), update leg {br['update_leg_ms']:.2f} ms "
            f"(kernel {br['kernel_ms']:.3f}, allgather {br['allgather_ms']:.2f}); "
            f"profiled step {br['profiled_step_ms']:.1f} ms, device busy "
            f"{br['device_busy_ms']} ms (share {br['device_busy_share']})")
    adam_batches = batches[:OVERLAP_ADAMW_STEPS]
    label = "train p=1 adamw overlap"
    adam_want = {"adamw_flat": OVERLAP_ADAMW_STEPS}
    mono = _overlap_run(f"{label} without overlap", model, sgd_mod.adamw(1e-3),
                        _overlap_sync(overlap=False), 1, adam_batches, adam_want)
    rec = _overlap_run(label, model, sgd_mod.adamw(1e-3), _overlap_sync(), 1,
                       adam_batches, adam_want)
    if rec["wire_bytes_per_step"] != [0] * OVERLAP_ADAMW_STEPS:
        raise AssertionError(f"{label}: wire bytes {rec['wire_bytes_per_step']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], mono["losses"])]
    if rel != [0.0] * OVERLAP_ADAMW_STEPS:   # p = 1: bitwise (tests/test_overlap.py)
        raise AssertionError(f"{label}: losses {rec['losses']} vs without "
                             f"overlap {mono['losses']}")
    rec["monolithic"] = mono
    report[label] = rec
    errs["adamw_flat"] = rec["hold_max_abs_err"]["adamw_flat"]
    br = rec["split"]
    log(f"[overlap] {label}: losses {[round(x, 4) for x in rec['losses']]} == "
        f"without overlap; step_ms {[round(x, 1) for x in rec['step_ms']]} (without "
        f"overlap {[round(x, 1) for x in mono['step_ms']]}); peak_mem "
        f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB (without "
        f"{mono['peak_mem_bytes'] / 2**30:.2f}) launches {rec['launches']}; split: "
        f"staged fwd+bwd {br['staged_fwd_bwd_ms']:.2f} ms, update leg "
        f"{br['update_leg_ms']:.2f} ms (kernel {br['kernel_ms']:.3f}); profiled step "
        f"{br['profiled_step_ms']:.1f} ms, device busy {br['device_busy_ms']} ms "
        f"(share {br['device_busy_share']})")
    log("[overlap] " + json.dumps({"overlap": report}, default=str))
    launches = {"sgd_momentum_flat": OVERLAP_STEPS, "adamw_flat": OVERLAP_ADAMW_STEPS}
    return launches, errs, report


# ---------------------------------------------------------------------------
# phase 9: serving (KV-cache decode, BatchedServer, chunked prefill)
# ---------------------------------------------------------------------------

#: decode_32k's KV cache at full-width qwen2-0.5b: 2·L·B·S·KV·D·2 bytes
DECODE_32K_KV_BYTES = 51_539_607_552
SERVE_DENSE = ("qwen2-0.5b", "qwen2.5-3b", "qwen3-4b", "phi3-medium-14b")
#: the param trees' numel at full width (param_count leaves out the norms)
SERVE_TREE_NUMEL = {"qwen2.5-3b": 3_086_200_832, "qwen3-4b": 4_412_079_616,
                    "phi3-medium-14b": 14_659_507_200}
#: decode against forward over the same tokens, bf16: |Δlogit| <= this x
#: max |forward logit|. Set from CPU runs at full width with the depth cut
#: to 2 / 4 / 8 layers (qwen2-0.5b: 1.05 / 1.17 / 1.56 %; the three other
#: configs at 2-4 layers: 1.05-1.48 %), with room for full depth.
SERVE_BAND_REL = 0.04
#: chunked (1024 / 1024) against one block, bf16, at S = 4096: |Δ| <= this
#: x max |one-block output| (CPU, full-width layer 0, S = 512 in 128-chunks:
#: 0.15 %)
CHUNK_BAND_REL = 1e-2
#: the ops a decode step would copy its cache through; each must move
#: less than one KV head's slice of one layer's k cache (B·S·D values)
COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous", "aten::cat",
            "aten::stack")


def _check_no_launches(label: str) -> None:
    got = counts(ALL_KERNELS)
    if any(got.values()):
        raise AssertionError(f"{label}: the serve path launched {got}")
    log(f"{label} launches of the 14 kernels: all 0")


def _logit_margins(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


class _StepRecorder:
    """Wraps a server's serve step: keeps each step's logits and its wall
    time (the step ends in ``torch.cuda.synchronize()``)."""

    def __init__(self, srv):
        self.step, self.logits, self.ms = srv._step, [], []
        srv._step = self

    def __call__(self, params, cache, tokens):
        t0 = time.perf_counter()
        logits, cache = self.step(params, cache, tokens)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.logits.append(logits)
        return logits, cache


def _ms_stats(ms: list) -> str:
    s = sorted(ms)
    return f"{s[len(s) // 2]:.3f} [{s[0]:.3f}–{s[-1]:.3f}]"


def _serve_profile(model, params, cache, tok, max_copy_numel=None) -> dict:
    """One more serve step under ``torch.profiler``: device busy share of
    the profiled wall time, and the largest copy-like op's numel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        model.serve_step(params, cache, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    def numel(shape) -> int:      # a tensor list's shapes come nested
        return sum(map(numel, shape)) if shape and isinstance(shape[0], list) \
            else math.prod(shape)

    copy = max([numel(e.input_shapes[0]) for e in prof.events()
                if e.name in COPY_OPS and e.input_shapes and e.input_shapes[0]]
               or [0])
    if max_copy_numel is not None and copy >= max_copy_numel:
        raise AssertionError(f"a serve step copied {copy} values (one KV "
                             f"head's slice of a layer's cache is {max_copy_numel})")
    return {"busy_ms": busy_ms or None, "wall_ms": wall_ms,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "largest_copy_numel": copy}


def _no_sync_step(model, params, cache, tok) -> None:
    """One serve step with CUDA's sync debug mode set to raise: the step
    makes no host sync (slot, mask and position stay on the device)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.serve_step(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _hold_decode_vs_forward(label, model, params, prompts, out, rec,
                            extra=None) -> dict:
    """Every serve step's logits against ``forward`` over the same tokens
    (and the ``extra`` batch entries), within SERVE_BAND_REL; where
    forward's top-1 margin exceeds twice the band, the greedy token equals
    forward's argmax."""
    V = model.cfg.vocab_size
    seq = torch.cat([prompts, out], dim=1)
    with torch.no_grad():
        fl = model.forward(params, {"tokens": seq, **(extra or {})}).float()[..., :V]
    dec = torch.cat(rec.logits[:seq.shape[1]], dim=1).float()[..., :V]
    scale = float(fl.abs().max())
    diff = float((dec - fl).abs().max())
    band = SERVE_BAND_REL * scale
    if not diff <= band:
        raise AssertionError(f"{label}: decode vs forward max |Δ| {diff} > band "
                             f"{band} ({SERVE_BAND_REL} x {scale})")
    P = prompts.shape[1]
    chose = fl[:, P - 1:P - 1 + out.shape[1]]
    sure = _logit_margins(chose) > 2 * band
    agree = out.long() == chose.argmax(-1)
    if not bool(agree[sure].all()):
        raise AssertionError(f"{label}: greedy token differs from forward's "
                             f"argmax at a margin > 2 x band")
    log(f"{label} decode vs forward over {seq.shape[1]} tokens: max |Δlogit| "
        f"{diff:.5f} <= {band:.5f} ({SERVE_BAND_REL} x max |logit| {scale:.3f}); "
        f"greedy == forward argmax at {int(sure.sum())} of {sure.numel()} steps "
        f"with margin > 2 x band (agree at {int(agree.sum())} of all)")
    del fl, dec
    return {"max_abs_diff": diff, "band": band, "checked": int(sure.sum()),
            "agree_all": int(agree.sum()), "steps": int(sure.numel())}


def _serve_run(label, model, params, prompts, new, max_seq, dev) -> dict:
    """BatchedServer.generate with every step recorded and timed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = BatchedServer(model, params, batch=prompts.shape[0], max_seq=max_seq,
                        device=dev)
    rec = _StepRecorder(srv)
    t0 = time.perf_counter()
    out = srv.generate(prompts, new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg, (B, P) = model.cfg, prompts.shape
    kv = nbytes(srv.cache["k"], srv.cache["v"])
    want_kv = (2 * cfg.num_layers * B * max_seq * cfg.num_kv_heads
               * cfg.resolved_head_dim * 2)
    if kv != want_kv:
        raise AssertionError(f"{label}: KV bytes {kv} != {want_kv}")
    if tuple(out.shape) != (B, new) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: tokens {tuple(out.shape)} max {int(out.max())}")
    if srv.cache["index"].tolist() != [P + new] * cfg.num_layers:
        raise AssertionError(f"{label}: cache index {srv.cache['index'].tolist()}")
    gen_ms = rec.ms[P:]
    weights = nbytes(*tree_leaves(params))
    _no_sync_step(model, params, srv.cache, out[:, -1:])
    hold = _hold_decode_vs_forward(label, model, params, prompts, out, rec)
    prof = _serve_profile(model, params, srv.cache, out[:, -1:])
    r = {"batch": B, "prompt": P, "new": new, "max_seq": max_seq,
         "prefill_ms": sum(rec.ms[:P]), "step_ms": rec.ms,
         "gen_ms_median": sorted(gen_ms)[len(gen_ms) // 2],
         "gen_ms_min": min(gen_ms), "gen_ms_max": max(gen_ms),
         "tokens_per_s": B * len(gen_ms) / (sum(gen_ms) / 1e3),
         "generate_wall_s": wall, "peak_mem_bytes": peak, "kv_bytes": kv,
         "kv_bytes_per_slot": kv // (B * max_seq), "weight_bytes": weights,
         "weight_bound_ms": weights / HBM_BYTES_PER_S * 1e3, "hold": hold,
         "profile": prof}
    log(f"{label}: batch {B}, max_seq {max_seq}, {P}-token prompts, {new} new "
        f"tokens: prefill {r['prefill_ms']:.1f} ms ({P} steps), ms per generated "
        f"token {_ms_stats(gen_ms)} (weight-stream bound "
        f"{r['weight_bound_ms']:.3f}: {weights} B at 3.35 TB/s), "
        f"{r['tokens_per_s']:.1f} tokens/s; peak {peak / 2**30:.2f} GiB; KV "
        f"{kv} B ({r['kv_bytes_per_slot']} B per token slot); a serve step "
        f"under sync debug mode 'error' made no host sync; device busy "
        f"{prof['busy_ms']} of {prof['wall_ms']:.2f} ms profiled "
        f"(share {prof['busy_share']})")
    del srv, rec
    return r


def phase_serve_small(dev) -> None:
    """The four reduced dense configs from the same weights, f32: 12
    teacher-forced serve steps' logits and the cache on the card within
    rtol 1e-4 / atol 1e-5 of the CPU, BatchedServer's greedy tokens equal."""
    reset_counts()
    for name in SERVE_DENSE:
        model = build_model(reduced(get_config(name)))
        p0 = model.init(device="cpu", seed=0)
        toks = torch.randint(0, model.cfg.vocab_size, (2, 12),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.int32)
        out = []
        for d in ("cpu", dev):
            params = tree_map(lambda a: a.to(d), p0)
            cache = model.init_cache(2, 16, d)
            steps = []
            for t in range(toks.shape[1]):
                logits, cache = model.serve_step(params, cache, toks[:, t:t + 1].to(d))
                steps.append(logits.cpu())
            srv = BatchedServer(model, params, batch=2, max_seq=24, device=d)
            out.append((torch.cat(steps, 1), tree_map(lambda a: a.cpu(), cache),
                        srv.generate(toks[:, :6].to(d), 8).cpu()))
        (cl, cc, cg), (gl, gc, gg) = out
        torch.testing.assert_close(gl, cl, rtol=1e-4, atol=1e-5)
        for key in ("k", "v"):
            torch.testing.assert_close(gc[key], cc[key], rtol=1e-4, atol=1e-5)
        if not (torch.equal(gc["index"], cc["index"]) and torch.equal(gg, cg)):
            raise AssertionError(f"[serve:small] {name}: index or greedy tokens "
                                 f"differ: {gg.tolist()} vs {cg.tolist()}")
        log(f"[serve:small] {name} (reduced, f32): 12 serve steps card == cpu "
            f"(max |Δlogit| {float((gl - cl).abs().max()):.2e}, rtol 1e-4 atol "
            f"1e-5), cache k/v/index held, greedy {gg.tolist()} == cpu")
    _check_no_launches("[serve:small]")


def _decode_32k(model, params, dev) -> dict:
    shape = INPUT_SHAPES["decode_32k"]
    cfg, B, S = model.cfg, shape.global_batch, shape.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = model.init_cache(B, S, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(cfg.num_layers):     # in place: no f32 draw of 12.9 G values
        cache["k"][i].normal_(generator=gen)
        cache["v"][i].normal_(generator=gen)
    cache["index"].fill_(S - 1)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    kv = nbytes(cache["k"], cache["v"])
    want_kv = 2 * cfg.num_layers * B * S * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    if not kv == want_kv == DECODE_32K_KV_BYTES:
        raise AssertionError(f"[serve] decode_32k KV bytes {kv} != {want_kv}")
    toks = TokenPipeline(DataConfig(seed=3, vocab_size=256, seq_len=9, batch_size=B),
                         device=dev).batch_at(0, 0)["tokens"]
    ms = []
    for t in range(8):
        t0 = time.perf_counter()
        logits, cache = model.serve_step(params, cache, toks[:, t:t + 1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError("[serve] decode_32k: non-finite logits")
    if cache["index"].tolist() != [S - 1 + 8] * cfg.num_layers:
        raise AssertionError(f"[serve] decode_32k index {cache['index'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    weights = nbytes(*tree_leaves(params))
    bound = (kv + weights) / HBM_BYTES_PER_S * 1e3
    head_slice = B * S * cfg.resolved_head_dim
    prof = _serve_profile(model, params, cache, toks[:, 8:9], head_slice)
    r = {"batch": B, "cache_len": S, "index": S - 1, "fill_s": fill_s, "step_ms": ms,
         "kv_bytes": kv, "weight_bytes": weights, "bound_ms": bound,
         "peak_mem_bytes": peak, "profile": prof,
         "tokens_per_s": B * len(ms) / (sum(ms) / 1e3)}
    log(f"[serve] decode_32k (B {B}, cache {S}, index {S - 1}; filled in place in "
        f"{fill_s:.2f} s): KV {kv} B == 2·L·B·S·KV·D·2; 8 serve steps ms "
        f"{_ms_stats(ms)} against the bound {bound:.2f} ms ((KV {kv} + weights "
        f"{weights}) B at 3.35 TB/s), {r['tokens_per_s']:.1f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; device busy {prof['busy_ms']} of "
        f"{prof['wall_ms']:.2f} ms profiled (share {prof['busy_share']}); "
        f"largest copy in a step {prof['largest_copy_numel']} values (< one "
        f"KV head's slice of a layer's cache, {head_slice})")
    return r


def _prefill_32k(model, params, dev) -> dict:
    S = INPUT_SHAPES["prefill_32k"].seq_len
    toks = TokenPipeline(DataConfig(seed=4, vocab_size=256, seq_len=S, batch_size=1),
                         device=dev).batch_at(0, 0)["tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            logits = model.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ok = bool(torch.isfinite(logits[..., :model.cfg.vocab_size]).all())
            del logits
    peak = torch.cuda.max_memory_allocated()
    if not ok:
        raise AssertionError("[serve] prefill_32k: non-finite logits")
    r = {"batch": 1, "seq": S, "ms": ms, "tokens_per_s": S / (min(ms) / 1e3),
         "peak_mem_bytes": peak}
    log(f"[serve] prefill_32k (batch cut 32 -> 1: the logits alone are "
        f"{S * model.cfg.padded_vocab * 2} B per sequence): forward 1 x {S} in "
        f"{[round(x, 1) for x in ms]} ms, {r['tokens_per_s']:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB")
    return r


def _chunk_hold(model, params, dev) -> dict:
    from repro_torch.models.attention import multi_head_attention
    from repro_torch.models.transformer import attn_spec

    S = 4096
    ap = {k: v[0] for k, v in params["layers"]["attn"].items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1, S, model.cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    spec = attn_spec(model.cfg)
    with torch.no_grad():
        run = {"chunked": lambda: multi_head_attention(ap, x, spec),
               "one block": lambda: multi_head_attention(ap, x, spec, q_chunk=S,
                                                         kv_chunk=S)}
        out = {k: f() for k, f in run.items()}
        ms = {k: cuda_ms(f, reps=3, warmup=1) for k, f in run.items()}
    one = out["one block"].float()
    diff = float((out["chunked"].float() - one).abs().max())
    band = CHUNK_BAND_REL * float(one.abs().max())
    if not diff <= band:
        raise AssertionError(f"[serve] chunked vs one block: {diff} > {band}")
    log(f"[serve] chunked (1024 / 1024) vs one block, layer-0 attention at S = "
        f"{S}, bf16: max |Δ| {diff:.5f} <= {band:.5f} ({CHUNK_BAND_REL} x max "
        f"|out|); ms chunked {ms['chunked']:.2f}, one block {ms['one block']:.2f}")
    return {"max_abs_diff": diff, "band": band, "ms": ms}


def phase_serve(dev) -> dict:
    """Full-width qwen2-0.5b, bf16: (a) BatchedServer, (b) decode_32k,
    (c) prefill_32k, and the chunked path against one block."""
    reset_counts()
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init(device=dev, seed=0)
    prompts = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=64,
                                       batch_size=8), device=dev).batch_at(0, 0)["tokens"]
    report = {"batched": _serve_run(f"[serve] {cfg.name} BatchedServer", model, params,
                                    prompts, 64, 256, dev)}
    torch.cuda.empty_cache()
    report["decode_32k"] = _decode_32k(model, params, dev)
    torch.cuda.empty_cache()
    report["prefill_32k"] = _prefill_32k(model, params, dev)
    torch.cuda.empty_cache()
    report["chunked"] = _chunk_hold(model, params, dev)
    _check_no_launches("[serve]")
    return report


def phase_serve_configs(dev) -> dict:
    """qwen2.5-3b, qwen3-4b and phi3-medium-14b at full width, bf16, one at
    a time: init on the card, BatchedServer batch 4 (max_seq 80), 32 + 32
    tokens."""
    reset_counts()
    report = {}
    for name in SERVE_DENSE[1:]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(get_config(name))
        t0 = time.perf_counter()
        params = model.init(device=dev, seed=0)
        torch.cuda.synchronize()
        init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        numel = sum(a.numel() for a in tree_leaves(params))
        if numel != SERVE_TREE_NUMEL[name]:
            raise AssertionError(f"[serve:configs] {name}: tree numel {numel}")
        log(f"[serve:configs] {name}: init on the card {init_s:.2f} s, init peak "
            f"{init_peak / 2**30:.2f} GiB; tree numel {numel} (param_count "
            f"{model.cfg.param_count()}, which leaves out the norm scales)")
        prompts = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=32,
                                           batch_size=4), device=dev).batch_at(0, 0)["tokens"]
        r = _serve_run(f"[serve:configs] {name}", model, params, prompts, 32, 80, dev)
        report[name] = dict(r, init_s=init_s, init_peak_bytes=init_peak, numel=numel)
        del params, model
    _check_no_launches("[serve:configs]")
    return report



# ---------------------------------------------------------------------------
# phase 10: the MoE, SSM and hybrid families (trained and served)
# ---------------------------------------------------------------------------

FAMILIES = ("qwen2-moe-a2.7b", "mixtral-8x7b", "mamba2-130m", "zamba2-1.2b",
            "whisper-base", "paligemma-3b")
FAMILY_STEPS = 3
#: the update leg's peak per param at p = 1 with bf16 params: the params
#: and grads (bf16), the momentum (f32), the packed grads and params (f32)
#: and both kernel outputs (f32)
TRAIN_BYTES_PER_PARAM = 2 + 2 + 4 + 4 + 4 + 4 + 4
#: [families] training cells: (config, depth, batch, seq, lr); seq counts
#: the VLM's image prefix (paligemma: 256 image + 256 text tokens), and
#: whisper's 1500 stub audio frames come beside its 448 tokens. qwen2-moe
#: is cut to 3 of 24 layers: 2.34 G params x 24 B = 56 GB (4 layers would
#: be 70 GB before activations); mixtral trains nowhere near one card.
#: paligemma trains at full depth: 2.51 G params x 24 B = 60.2 GB (56.1
#: GiB), under the ~74 GiB at which its depth would be cut.
FAMILY_TRAIN = (("mamba2-130m", 24, 8, 512, 0.1), ("zamba2-1.2b", 38, 4, 512, 0.1),
                ("qwen2-moe-a2.7b", 3, 4, 512, 0.1), ("whisper-base", 6, 8, 448, 0.1),
                ("paligemma-3b", 18, 2, 512, 0.1))
#: [families] serving cells: (config, depth, batch, prompt, new tokens).
#: Depths cut to pay for phase 15's [gspmd:families]: mamba2 24 ->
#: 8, zamba2 38 -> 12 (two shared-block calls), qwen2-moe 24 -> 4,
#: mixtral 8 -> 2, paligemma 18 -> 6; whisper-base is whole (6)
FAMILY_SERVE = (("mamba2-130m", 8, 8, 64, 64), ("zamba2-1.2b", 12, 4, 32, 32),
                ("qwen2-moe-a2.7b", 4, 4, 32, 32), ("mixtral-8x7b", 2, 4, 32, 32),
                ("whisper-base", 6, 8, 32, 32), ("paligemma-3b", 6, 4, 32, 32))
#: f32 decode against f32 forward over the served tokens: |Δlogit| <= this
#: x max |forward logit| (CPU at full width, 4 / 8 layers: 1.9e-6 / 8.7e-6)
FAMILY_F32_BAND_REL = 1e-3


def _family_cfg(name: str, depth: int):
    return dataclasses.replace(get_config(name), num_layers=depth)


def _with_stubs(cfg, batch, seed, device="cpu"):
    """The stub frontends' inputs the audio and VLM families take beside
    the tokens (the reference's train CLI feeds neither): N(0, 1) audio
    frames / image embeddings from a seeded CPU generator, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    out = dict(batch)
    B = batch["tokens"].shape[0]
    if cfg.is_enc_dec:
        out["audio_frames"] = torch.randn((B, cfg.enc_seq_len, cfg.d_model),
                                          generator=gen).to(device)
    if cfg.num_image_tokens:
        out["image_embeds"] = torch.randn((B, cfg.num_image_tokens, cfg.d_model),
                                          generator=gen).to(device)
    return out


def phase_families_small(dev) -> None:
    """The four reduced configs from the same weights, f32: 3 momentum-SGD
    steps on the card (one sgd_momentum_flat launch each) against the CPU,
    losses within rtol 1e-4; 12 teacher-forced serve steps' logits and the
    cache within rtol 1e-4 / atol 1e-5 and BatchedServer's greedy tokens
    equal, with no launch of the 14 kernels. Whisper and paligemma train on
    stub frame / image embeddings beside the tokens; whisper's serve steps
    cross-attend a seeded random ``enc`` in the cache (the server's own
    stays the zeros ``init_cache`` made)."""
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=80, batch_size=4))
    for name in FAMILIES:
        model = build_model(reduced(get_config(name)))
        p0 = model.init(device="cpu", seed=0)
        toks = torch.randint(0, model.cfg.vocab_size, (2, 12),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.int32)
        out = {}
        for d in ("cpu", dev):
            opt, sync = sgd_optimizer(0.1, momentum=0.9), SyncConfig()
            state = make_train_state(model, opt, sync, device="cpu")
            state["params"] = p0
            state = tree_map(lambda a: a.to(d), state)
            step = make_train_step(model, opt, sync, device=d)
            reset_counts()
            losses = []
            for i in range(FAMILY_STEPS):
                state, met = step(state, _with_stubs(model.cfg, pipe.batch_at(0, i), i))
                losses.append(float(met["loss"]))
            launches = counts(ALL_KERNELS)
            del state, step
            reset_counts()
            params = tree_map(lambda a: a.to(d), p0)
            cache = model.init_cache(2, 16, d)
            if "enc" in cache:
                cache["enc"].copy_(torch.randn(cache["enc"].shape,
                                               generator=torch.Generator().manual_seed(1)))
            steps = []
            for t in range(toks.shape[1]):
                logits, cache = model.serve_step(params, cache, toks[:, t:t + 1].to(d))
                steps.append(logits.cpu())
            srv = BatchedServer(model, params, batch=2, max_seq=24, device=d)
            greedy = srv.generate(toks[:, :6].to(d), 8).cpu()
            if str(torch.device(d).type) == "cuda":
                _check_launches(f"[families:small] {name} train", launches,
                                {"sgd_momentum_flat": FAMILY_STEPS}, FAMILY_STEPS)
                _check_no_launches(f"[families:small] {name} serve")
            out[torch.device(d).type] = (losses, torch.cat(steps, 1),
                                         tree_map(lambda a: a.cpu(), cache), greedy)
        (cl, clog, cc, cg), (gl, glog, gc, gg) = out["cpu"], out["cuda"]
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl), rtol=1e-4, atol=0)
        torch.testing.assert_close(glog, clog, rtol=1e-4, atol=1e-5)
        for a, b in zip(tree_leaves(gc), tree_leaves(cc)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        if not torch.equal(gg, cg):
            raise AssertionError(f"[families:small] {name}: greedy tokens differ: "
                                 f"{gg.tolist()} vs {cg.tolist()}")
        log(f"[families:small] {name} (reduced, f32): {FAMILY_STEPS} train steps "
            f"card {[round(x, 5) for x in gl]} == cpu (rtol 1e-4), "
            f"sgd_momentum_flat {FAMILY_STEPS} launches; 12 serve steps card == cpu "
            f"(max |Δlogit| {float((glog - clog).abs().max()):.2e}, rtol 1e-4 atol "
            f"1e-5), cache held, greedy {gg.tolist()} == cpu")


def _family_bytes(cfg) -> dict:
    """The full-width cell's bytes, reckoned from shapes before any
    allocation: the param tree, its bf16 weights, the training peak at
    TRAIN_BYTES_PER_PARAM and init's largest leaf drawn in f32."""
    meta = build_model(cfg).init(device="meta")
    numel = sum(a.numel() for a in tree_leaves(meta))
    return {"numel": numel, "weight_bytes": nbytes(*tree_leaves(meta)),
            "train_bytes": numel * TRAIN_BYTES_PER_PARAM,
            "init_f32_leaf_bytes": max(a.numel() for a in tree_leaves(meta)) * 4}


def _family_train(name, depth, B, S, lr, dev) -> dict:
    cfg = _family_cfg(name, depth)
    model = build_model(cfg)
    opt, sync = sgd_optimizer(lr, momentum=0.9), SyncConfig()
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256,
                                    seq_len=S - cfg.num_image_tokens, batch_size=B),
                         device=dev)
    batches = [_with_stubs(cfg, pipe.batch_at(0, i), i, dev) for i in range(FAMILY_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, opt, sync, device=dev)
    step = make_train_step(model, opt, sync, device=dev)
    label = f"[families] {name} train ({depth} layers, {B} x {S})"
    losses, step_ms = [], []
    reset_counts()
    for batch in batches:
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    got = counts(ALL_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    _check_launches(label, got, {"sgd_momentum_flat": FAMILY_STEPS}, FAMILY_STEPS)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall {losses}")
    with _KernelHold() as hold:           # one more step, not timed
        step(state, batches[0])
    share, busy_ms, wall_ms = _device_busy(step, state, batches[0])
    r = {"depth": depth, "batch": B, "seq": S, "lr": lr, "losses": losses,
         "step_ms": step_ms, "peak_mem_bytes": peak,
         "launches": {k: v for k, v in got.items() if v},
         "hold_max_abs_err": hold.err.get("sgd_momentum_flat"),
         "device_busy_share": share, "device_busy_ms": busy_ms,
         "profiled_step_ms": wall_ms}
    log(f"{label}: losses {[round(x, 4) for x in losses]} falling; step ms "
        f"{[round(x, 1) for x in step_ms]}; peak {peak / 2**30:.2f} GiB; launches "
        f"{r['launches']}; kernel hold ({'; '.join(hold.calls)}) == plain: "
        f"max_abs_err {r['hold_max_abs_err']}; device busy {busy_ms} of "
        f"{wall_ms:.1f} ms profiled (share {share})")
    del state, step
    torch.cuda.empty_cache()
    return r


def _hold_decode_vs_forward_f32(label, model, params, seq) -> dict:
    """The served tokens again, in f32 (TF32 off): every teacher-forced
    serve step's logits against f32 ``forward`` over the same tokens,
    within FAMILY_F32_BAND_REL of max |logit| — the SSM decode path against
    the chunked SSD at the card's full width."""
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    m32 = build_model(cfg)
    p32 = tree_map(lambda a: a.float(), params)
    V = cfg.vocab_size
    with torch.no_grad():
        fl = m32.forward(p32, {"tokens": seq}).float()[..., :V]
        cache = m32.init_cache(seq.shape[0], seq.shape[1], seq.device)
        dec = []
        for t in range(seq.shape[1]):
            logits, cache = m32.serve_step(p32, cache, seq[:, t:t + 1])
            dec.append(logits.float()[..., :V])
    dec = torch.cat(dec, 1)
    scale = float(fl.abs().max())
    diff = float((dec - fl).abs().max())
    if not diff <= FAMILY_F32_BAND_REL * scale:
        raise AssertionError(f"{label}: f32 decode vs forward max |Δ| {diff} > "
                             f"{FAMILY_F32_BAND_REL} x {scale}")
    del p32, cache, fl, dec
    return {"f32_max_abs_diff": diff, "f32_scale": scale,
            "f32_band": FAMILY_F32_BAND_REL * scale}


def _decode_weight_bytes(cfg, params) -> int:
    """The weights one decode step reads: all of them but, for the enc-dec,
    only the decoder stack, the head and its final norm (not the encoder,
    its positions, nor all but one row of the decoder's position table)."""
    if not cfg.is_enc_dec:
        return nbytes(*tree_leaves(params))
    return nbytes(*tree_leaves(params["decoder"]), params["lm_head"],
                  params["final_norm"], params["final_norm_b"])


def _hold_family_decode(label, model, params, prompts, out, rec) -> dict:
    """The served logits against ``forward`` over the served tokens in the
    dense family's bf16 band, for the two families whose decode sees less
    than their forward: the VLM's decode is text only, so against the
    forward of its text-only twin (``num_image_tokens=0``, the same
    params); the enc-dec's serve cache cross-attends to zeros, so against
    the forward whose encoder output is zero (its final LayerNorm's scale
    and bias zeroed, which the decode never reads)."""
    cfg = model.cfg
    if cfg.num_image_tokens:
        twin = build_model(dataclasses.replace(cfg, num_image_tokens=0))
        return _hold_decode_vs_forward(label, twin, params, prompts, out, rec)
    zeroed = dict(params, enc_final_norm=torch.zeros_like(params["enc_final_norm"]),
                  enc_final_norm_b=torch.zeros_like(params["enc_final_norm_b"]))
    frames = torch.zeros((prompts.shape[0], cfg.enc_seq_len, cfg.d_model),
                         dtype=cfg.torch_dtype, device=prompts.device)
    return _hold_decode_vs_forward(label, model, zeroed, prompts, out, rec,
                                   extra={"audio_frames": frames})


def _family_serve(name, depth, B, P, new, dev) -> dict:
    cfg = _family_cfg(name, depth)
    model = build_model(cfg)
    label = f"[families] {name} serve ({depth} layers)"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(device=dev, seed=0)
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    prompts = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=P, batch_size=B),
                            device=dev).batch_at(0, 0)["tokens"]
    torch.cuda.reset_peak_memory_stats()
    max_seq = P + new
    srv = BatchedServer(model, params, batch=B, max_seq=max_seq, device=dev)
    rec = _StepRecorder(srv)
    out = srv.generate(prompts, new)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (B, new) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: tokens {tuple(out.shape)} max {int(out.max())}")
    logits = torch.cat(rec.logits, 1)[..., :cfg.vocab_size]
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite logits")
    cache_bytes = nbytes(*tree_leaves(srv.cache))
    weights = _decode_weight_bytes(cfg, params)
    gen_ms = rec.ms[P:]
    _no_sync_step(model, params, srv.cache, out[:, -1:])
    prof = _serve_profile(model, params, srv.cache, out[:, -1:])
    r = {"depth": depth, "batch": B, "prompt": P, "new": new, "max_seq": max_seq,
         "init_s": init_s, "init_peak_bytes": init_peak,
         "prefill_ms": sum(rec.ms[:P]), "step_ms": rec.ms,
         "gen_ms_median": sorted(gen_ms)[len(gen_ms) // 2],
         "gen_ms_min": min(gen_ms), "gen_ms_max": max(gen_ms),
         "tokens_per_s": B * len(gen_ms) / (sum(gen_ms) / 1e3),
         "peak_mem_bytes": peak, "weight_bytes": weights, "cache_bytes": cache_bytes,
         "bound_ms": (weights + cache_bytes) / HBM_BYTES_PER_S * 1e3, "profile": prof}
    if cfg.arch_type in ("ssm", "hybrid"):
        seq = torch.cat([prompts, out], dim=1)
        with torch.no_grad():
            fl = model.forward(params, {"tokens": seq}).float()[..., :cfg.vocab_size]
        bf16_rel = float((logits.float() - fl).abs().max() / fl.abs().max())
        del fl
        r["bf16_decode_vs_forward_rel"] = bf16_rel
        r.update(_hold_decode_vs_forward_f32(label, model, params, seq))
        log(f"{label} decode vs forward over {seq.shape[1]} tokens: f32 max |Δlogit| "
            f"{r['f32_max_abs_diff']:.3e} <= {r['f32_band']:.3e} "
            f"({FAMILY_F32_BAND_REL} x max |logit| {r['f32_scale']:.3f}); bf16 "
            f"(the served run) max |Δlogit| {bf16_rel:.4f} of max |logit|")
    elif cfg.arch_type in ("audio", "vlm"):
        r["hold"] = _hold_family_decode(label, model, params, prompts, out, rec)
    log(f"{label}: init {init_s:.2f} s, init peak {init_peak / 2**30:.2f} GiB; batch "
        f"{B}, {P}-token prompts, {new} new tokens: prefill {r['prefill_ms']:.1f} ms, "
        f"ms per generated token {_ms_stats(gen_ms)} (bytes bound {r['bound_ms']:.3f}: "
        f"weights {weights} + cache {cache_bytes} B at 3.35 TB/s), "
        f"{r['tokens_per_s']:.1f} tokens/s; peak {peak / 2**30:.2f} GiB; a serve step "
        f"under sync debug mode 'error' made no host sync; device busy "
        f"{prof['busy_ms']} of {prof['wall_ms']:.2f} ms profiled (share "
        f"{prof['busy_share']})")
    del srv, rec, params, logits
    torch.cuda.empty_cache()
    return r


def phase_families(dev) -> dict:
    """Full width in bf16, depth cut where one card forces it: the bytes
    reckoned first, then the training cells (FAMILY_STEPS momentum-SGD
    steps each) and the serving cells (BatchedServer), one at a time."""
    for name, depth in dict.fromkeys(c[:2] for c in FAMILY_TRAIN + FAMILY_SERVE):
        b = _family_bytes(_family_cfg(name, depth))
        log(f"[families] bytes {name} at {depth} layers: {b['numel']} params, bf16 "
            f"weights {b['weight_bytes'] / 1e9:.2f} GB, training at "
            f"{TRAIN_BYTES_PER_PARAM} B/param {b['train_bytes'] / 1e9:.2f} GB, init's "
            f"largest leaf in f32 {b['init_f32_leaf_bytes'] / 1e9:.2f} GB")
    report = {"train": {}, "serve": {}}
    for name, depth, B, S, lr in FAMILY_TRAIN:
        report["train"][name] = _family_train(name, depth, B, S, lr, dev)
    reset_counts()
    for name, depth, B, P, new in FAMILY_SERVE:
        report["serve"][name] = _family_serve(name, depth, B, P, new, dev)
    _check_no_launches("[families] serve")
    return report


# ---------------------------------------------------------------------------
# phase 11: the paper's ResNet through the six PS / MPI modes
# ---------------------------------------------------------------------------

#: [resnet:small]: the example's six modes (and mpi-ESGD over the int8 PS
#: wire) at 2 of its 3 epochs
RESNET_SMALL_EPOCHS = 2
#: [resnet]: the paper's scale from the same dataclass — ResNet-34's stage
#: layout under the reference's basic GN block, stride-1 stem, no pool
RESNET_PAPER = ResNetConfig(stage_sizes=(3, 4, 6, 3), width=64, num_classes=1000,
                            image_size=224)
RESNET_PARAMS = 21_788_200
RESNET_BATCH = 8          # images per worker pass
RESNET_EVAL_BATCH = 64
#: [ps]'s layout (4 workers in 2 clients, 8 completions, 4 exchanges) at
#: lr 1e-3: at 0.1 (the example's) the 1000-class head overshoots and the
#: center's eval loss rises above its start
RESNET_RUN = dict(PS_RUN, lr=1e-3)


def phase_resnet_small(dev) -> None:
    """The example's ResNet (stage sizes (1, 1), width 8, 8 px) through all
    six modes of ``algorithms.run`` and mpi-ESGD over the int8 PS wire, on
    the card against the CPU from the same seed: the simulated clock
    equal, the training losses within rtol 1e-4, the eval accuracy within
    one test sample (1/256)."""
    runs = [(m, None) for m in alg.MODES] + [("mpi_esgd", "int8")]
    for mode, wire in runs:
        cfg = hyb.example_config(mode, epochs=RESNET_SMALL_EPOCHS,
                                 policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                         wire_dtype=wire))
        c, g = (hyb.run_example(cfg, d) for d in ("cpu", dev))
        for f in ("times", "epochs", "epoch_time", "mean_staleness", "live_clients",
                  "pushed_bytes"):
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(f"[resnet:small] {mode} {wire}: {f} card "
                                     f"{getattr(g, f)} != cpu {getattr(c, f)}")
        torch.testing.assert_close(torch.tensor(g.losses), torch.tensor(c.losses),
                                   rtol=1e-4, atol=0)
        acc_diff = max(abs(a - b) for a, b in zip(g.metrics, c.metrics))
        if not acc_diff <= 1 / 256 + 1e-9:
            raise AssertionError(f"[resnet:small] {mode} {wire}: accuracy card "
                                 f"{g.metrics} vs cpu {c.metrics}")
        log(f"[resnet:small] {mode} wire={wire}: clock {g.times[-1]:.6f} s / epoch_time "
            f"{g.epoch_time:.6f} / staleness {g.mean_staleness:.3f} == cpu; {len(g.losses)} "
            f"losses {g.losses[0]:.5f} .. {g.losses[-1]:.5f} within rtol 1e-4; accuracy "
            f"{g.metrics} (cpu {c.metrics}, max |Δ| {acc_diff})")


def _resnet_reckon(cfg: ResNetConfig) -> tuple[int, int]:
    """(forward flops per image, f32 bytes per image of the maps a backward
    keeps) from the block plan: 2 flops per multiply-add of every conv and
    the head; per conv its output and its GroupNorm's and ReLU's, and the
    projection's output (the residual sum's ReLU counted once)."""
    H = cfg.image_size
    flops, maps = 2 * H * H * 27 * cfg.width, 3 * H * H * cfg.width
    plan, c_final = _block_plan(cfg)
    for stride, ci, co in plan:
        H = -(-H // stride)
        proj = stride != 1 or ci != co
        flops += 2 * H * H * 9 * (ci * co + co * co) + (2 * H * H * ci * co if proj else 0)
        maps += H * H * co * (6 + (1 if proj else 0))
    return flops + 2 * c_final * cfg.num_classes, 4 * maps


def phase_resnet(dev) -> tuple[dict, dict, dict]:
    """The paper-scale ResNet (21,788,200 f32 params) through mpi-ESGD with
    4 workers in 2 clients, B 8 per worker, 8 completions and 4 exchanges,
    over the int8 and then the f32 PS wire: launch counts, the kernels held
    on the run's own operands, PS wire bytes against the cost model, the
    center's eval loss below its start on a 64-image test batch, a
    completion's split, peak memory and device busy."""
    cfg_r = RESNET_PAPER
    flops, act = _resnet_reckon(cfg_r)
    t0 = time.perf_counter()
    pipes = [ImagePipeline(DataConfig(seed=0, batch_size=RESNET_BATCH,
                                      steps_per_epoch=PS_ITERS, shard=w),
                           image_size=cfg_r.image_size, num_classes=cfg_r.num_classes,
                           device=dev) for w in range(RESNET_RUN["num_workers"])]
    test = ImagePipeline(DataConfig(seed=0, batch_size=RESNET_EVAL_BATCH,
                                    steps_per_epoch=1, shard=999),
                         image_size=cfg_r.image_size, num_classes=cfg_r.num_classes,
                         device=dev).batch_at(99, 0)
    host_s = time.perf_counter() - t0
    proto = nbytes(torch.from_numpy(pipes[0]._proto))
    log(f"[resnet] {cfg_r}: reckoned {flops / 1e9:.1f} GFLOP forward and "
        f"{act / 1e9:.2f} GB of kept f32 maps per image ({RESNET_BATCH} per worker "
        f"pass: {3 * flops * RESNET_BATCH / 1e12:.2f} TFLOP forward + backward, "
        f"{act * RESNET_BATCH / 2**30:.2f} GiB); {len(pipes) + 1} ImagePipelines of "
        f"{proto} B prototypes each drawn in {host_s:.2f} s host")

    @torch.no_grad()
    def evaluate(params) -> float:
        return float(resnet_loss(params, test, cfg_r)[0])

    grad = hyb.make_grad_fn(cfg_r)
    launches, errs, report = {}, {}, {}
    for wire in ("int8", None):
        params0 = init_resnet(torch.Generator().manual_seed(0), cfg_r, dev)
        spec = flatbuf.spec_for(params0)
        if spec.payload != RESNET_PARAMS:
            raise AssertionError(f"[resnet] {spec.payload} params, want {RESNET_PARAMS}")
        cfg = alg.AlgoConfig(**RESNET_RUN, model_bytes=4.0 * spec.payload,
                             policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                     wire_dtype=wire))
        start = evaluate(params0)
        tree_bytes = nbytes(*tree_leaves(params0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _ExchangeRecorder() as rec, _KernelHold() as hold:
            t0 = time.perf_counter()
            hist = alg.run(cfg, lambda gen: params0, grad, evaluate,
                           lambda w: pipes[w], device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        got = counts(ALL_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        want = {"quantize_wire": 4 if wire else 0, "dequantize_wire": 4 if wire else 0,
                "elastic_server_flat": 4, "elastic_client_flat": 4,
                "sgd_momentum_flat": 2 * PS_ITERS}
        label = f"[resnet] mpi_esgd wire={wire or 'f32'}"
        _check_launches(label, got, want, 2 * PS_ITERS)
        # each client step's gradient legs over its 2 workers, 2 rings
        hop = _hop_launches(label, _hop_want(2, 2, 2 * PS_ITERS) if wire else None)
        if wire:
            launches = dict(want)
        if not all(math.isfinite(x) for x in hist.losses + hist.metrics):
            raise AssertionError(f"{label}: non-finite loss {hist.losses} {hist.metrics}")
        if not hist.metrics[-1] < start:
            raise AssertionError(f"{label}: the center's eval loss {hist.metrics[-1]} "
                                 f"is not below its start {start}")
        # the cost model pads the int8 codes to whole 128-value buckets; the
        # in-process KVStore counts the payload's codes unpadded, as the
        # reference's does (21,788,200 = 128 x 170,220 + 40: 88 pad codes a push)
        pushes = 4
        pad = -spec.payload % qb.WIRE_BLOCK
        want_bytes = (pushes * (cost_model.ps_wire_nbytes(spec.payload, "int8") - pad)
                      if wire else pushes * tree_bytes)
        if hist.pushed_bytes != want_bytes:
            raise AssertionError(f"{label}: {hist.pushed_bytes} PS wire bytes, cost "
                                 f"model {want_bytes}")
        params, center, alpha = rec.last
        held = _hold_last_exchange(spec, params, center, alpha, wire)
        held["sgd_momentum_flat"] = hold.err["sgd_momentum_flat"]
        for name, e in held.items():
            errs[name] = max(errs.get(name, 0.0), e)
        log(f"{label}: losses {[round(x, 5) for x in hist.losses]} center eval loss "
            f"{start:.5f} -> {hist.metrics[-1]:.5f}; launches "
            f"{ {k: v for k, v in got.items() if v} }, per-hop codec {hop}; PS wire "
            f"bytes {hist.pushed_bytes} "
            f"== cost model{f' (less {pushes} x {pad} pad codes)' if wire else ''}; "
            f"PS-tier kernels == "
            f"plain on the last exchange's operands, "
            f"sgd_momentum_flat on all {len(hold.calls)} of its own within phase 2's "
            f"tolerances (max_abs_err {held['sgd_momentum_flat']}); simulated epoch "
            f"{hist.epoch_time:.4f} s")
        batches = [pipes[w].batch_at(0, PS_ITERS - 1) for w in range(2)]
        split = _ps_split(cfg, None, grad, params, center, batches)
        del params, center, rec, params0
        report[label] = {"losses": hist.losses, "center_eval": [start] + hist.metrics,
                         "run_ms": wall_ms, "peak_mem_bytes": peak,
                         "pushed_bytes": hist.pushed_bytes,
                         "launches": {k: v for k, v in got.items() if v},
                         "pipeline_host_s": host_s, **split}
        log(f"{label}: run {wall_ms:.1f} ms for 8 completions (one eval and every "
            f"sgd launch's hold included); peak {peak / 2**30:.2f} GiB; split: fwd+bwd "
            f"(2 workers x {RESNET_BATCH}) {split['fwd_bwd_ms']:.2f} ms, intra-client "
            f"allreduce {split['allreduce_ms']:.2f} ms, push (wire + server rule) "
            f"{split['push_ms']:.2f} ms, exchange (Elastic2) {split['elastic2_ms']:.2f} "
            f"ms, update {split['update_ms']:.2f} ms -> exchange completion "
            f"{split['exchange_completion_ms']:.1f} ms; device busy "
            f"{split['device_busy_ms']} of {split['profiled_ms']:.1f} ms profiled "
            f"(share {split['device_busy_share']})")
        torch.cuda.empty_cache()
    del pipes
    return launches, errs, report


# ---------------------------------------------------------------------------
# slice 11: the socket PS tier (net/) over TCP on 127.0.0.1
# ---------------------------------------------------------------------------

#: [net:small]: logreg8, 2 workers + 1 server, 2 epochs of 2 steps, an
#: exchange every step; (mode, wire) runs, each on the card and the CPU
NET_SMALL = (("dist_sgd", None), ("dist_sgd", "int8"), ("dist_esgd", None),
             ("dist_esgd", "bf16"))
NET_SMALL_RUN = dict(num_workers=2, num_clients=2, num_servers=1, lr=0.1,
                     momentum=0.9, epochs=2, steps_per_epoch=2, esgd_interval=1,
                     jitter=0.0, seed=0)
#: [net]: the paper-scale ResNet, 2 workers of 16 images; dist_esgd 4
#: steps (an exchange every step), dist_sgd 3
NET_BATCH = 16
NET_RUNS = (("dist_esgd", "int8", 4), ("dist_esgd", None, 4), ("dist_sgd", None, 3))
NET_RUN = dict(num_workers=2, num_clients=2, num_servers=1, lr=1e-3, momentum=0.9,
               esgd_alpha=0.5, esgd_interval=1, epochs=1, jitter=0.0, seed=0)
NET_JOIN_S = 600.0
#: the paper-scale ResNet's FlatBuffer length (RESNET_PARAMS padded)
RESNET_FLAT = 21_789_696
#: the worker outputs' exit records, held equal card vs CPU
NET_RECORD = ("gsteps", "metric_epochs", "exchanges", "degraded_seen", "partial",
              "resumed_from", "rank", "attempt", "resume", "ps", "mpi", "kv")


class _Turnstile:
    """Puts the dist_esgd exchanges in the in-process engine's order (unit
    0, unit 1, per step): exchange (it, u) waits for its turn, which moves
    on when unit u reports ``progress`` for it — so a card run and a CPU
    run see the same center."""

    def __init__(self, units: int):
        self.units, self.turn = units, 0
        self.cond = threading.Condition()

    def server(self, handle):
        def wrapped(op, meta, payload):
            if op == "elastic_exchange":
                idx = int(meta["step"]) * self.units + int(meta["unit"])
                with self.cond:
                    if not self.cond.wait_for(lambda: self.turn == idx, NET_JOIN_S):
                        raise TimeoutError(f"exchange turn {idx} never came")
            return handle(op, meta, payload)
        return wrapped

    def rendezvous(self, handle):
        def wrapped(op, meta, payload):
            if op == "progress":
                idx = int(meta["step"]) * self.units + int(meta["rank"])
                with self.cond:
                    if self.turn == idx:
                        self.turn += 1
                        self.cond.notify_all()
            return handle(op, meta, payload)
        return wrapped


class _NetTier:
    """A port rendezvous and one port KVServer on ``dev``, served over TCP
    on ephemeral ports of 127.0.0.1; ``tap(op, meta, payload)`` sees every
    request the server gets."""

    def __init__(self, cfg, dev, *, ordered=False, tap=None):
        self.tr = net_transport.transport_for("tcp")
        self.rdzv = net_rdzv.Rendezvous(
            num_workers=cfg.num_workers, num_servers=1, num_clients=cfg.num_workers,
            algo=net_rdzv.algo_to_dict(cfg))
        self.kv = net_kvserver.KVServer(cfg, device=dev)
        gate = _Turnstile(cfg.num_workers) if ordered else None
        handle = self.kv.handle
        if tap is not None:
            def handle(op, meta, payload, _h=self.kv.handle):
                tap(op, meta, payload)
                return _h(op, meta, payload)
        self.served = [self.tr.serve(gate.rendezvous(self.rdzv.handle) if gate
                                     else self.rdzv.handle),
                       self.tr.serve(gate.server(handle) if gate else handle)]
        self.addr = self.served[0].addr
        conn = self.tr.connect(self.addr)
        net_rdzv.join_rendezvous(conn, "server", 0, addr=self.served[1].addr)
        conn.close()

    def stats(self) -> dict:
        return self.kv.handle("stats", {}, b"")[0]

    def close(self) -> None:
        for s in self.served:
            s.close()


def _net_threads(fn, ranks) -> dict:
    """``fn(rank)`` in one thread per rank, each joined within NET_JOIN_S;
    a thread that raised re-raises here."""
    out, errs = {}, {}

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs[r] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(NET_JOIN_S)
    alive = [r for r, t in zip(ranks, threads) if t.is_alive()]
    if alive:
        raise AssertionError(f"[net] worker threads {alive} still running after "
                             f"{NET_JOIN_S} s")
    if errs:
        raise next(iter(errs.values()))
    return out


def _net_losses(mode, outs, steps_per_epoch) -> list:
    """The in-process runner's loss record: dist_sgd the per-step mean over
    workers, dist_esgd the epoch mean over completions in turnstile order."""
    ranks = sorted(outs)
    n = len(outs[ranks[0]]["losses"])
    if mode == "dist_sgd":
        return [float(np.mean([outs[r]["losses"][i] for r in ranks])) for i in range(n)]
    return [float(np.mean([outs[r]["losses"][i] for i in range(e, e + steps_per_epoch)
                           for r in ranks])) for e in range(0, n, steps_per_epoch)]


def _net_hop_want(steps, workers=2) -> dict:
    """The per-hop launches of a dist_esgd int8 socket run: an exchange per
    step per worker, whose push and reply are each encoded once and
    decoded once."""
    frames = 2 * workers * steps
    return {"wire_encode": frames, "wire_decode": frames, "wire_decode_add_encode": 0}


def _net_want(mode, steps, workers=2) -> dict:
    """Launch counts of one socket run: the fused SGD kernel once per step
    per worker; on dist_esgd Elastic2 on the worker and Elastic1 on the
    server once per exchange; nothing else."""
    want = {"sgd_momentum_flat": workers * steps}
    if mode == "dist_esgd":
        want.update(elastic_client_flat=workers * steps,
                    elastic_server_flat=workers * steps)
    return want


def phase_net_small(dev) -> None:
    """logreg8 through ``run_worker`` threads against a port rendezvous and
    KVServer over TCP, on the card and on the CPU: losses and metrics
    within rtol 1e-4, exit records, counters and live sets equal, bytes
    per push == the cost model, launches as stated."""
    for mode, wd in NET_SMALL:
        cfg = alg.AlgoConfig(mode=mode, **NET_SMALL_RUN, policy=CollectivePolicy(
            method="multi_ring", num_rings=2, wire_dtype=wd))
        steps = cfg.epochs * cfg.steps_per_epoch
        res = {}
        for d in ("cpu", dev):
            tier = _NetTier(cfg, d, ordered=mode == "dist_esgd")
            reset_counts()
            try:
                outs = _net_threads(lambda r: net_worker.run_worker(
                    rank=r, rendezvous_addr=tier.addr, transport="tcp", device=d),
                    [0, 1])
                torch.cuda.synchronize()
                got = {k: v for k, v in counts(ALL_KERNELS).items() if v}
                stats = tier.stats()
            finally:
                tier.close()
            res[str(d)] = (outs, stats, got)
        (c_outs, c_stats, c_got), (g_outs, g_stats, g_got) = res["cpu"], res[str(dev)]
        label = f"[net:small] {mode} wire={wd or 'f32'}"
        if c_got:
            raise AssertionError(f"{label}: the CPU run launched {c_got}")
        want = _net_want(mode, steps)
        if g_got != want:
            raise AssertionError(f"{label}: launches {g_got}, want {want}")
        cl, gl = (_net_losses(mode, o, cfg.steps_per_epoch) for o in (c_outs, g_outs))
        torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl), rtol=1e-4, atol=0)
        for r in (0, 1):
            torch.testing.assert_close(torch.tensor(g_outs[r]["metrics"]),
                                       torch.tensor(c_outs[r]["metrics"]),
                                       rtol=1e-4, atol=0)
            for k in NET_RECORD:
                if g_outs[r].get(k) != c_outs[r].get(k):
                    raise AssertionError(f"{label}: worker {r} {k} card "
                                         f"{g_outs[r].get(k)} != cpu {c_outs[r].get(k)}")
        for k in ("degraded_syncs", "late_pushes", "live", "membership_epoch",
                  "push_count", "bytes"):
            if g_stats[k] != c_stats[k]:
                raise AssertionError(f"{label}: server {k} card {g_stats[k]} != cpu "
                                     f"{c_stats[k]}")
        n = flatbuf.spec_for(net_problem.build_problem("logreg8", device="cpu").init_fn(
            torch.Generator().manual_seed(0))).size
        per_push = cost_model.ps_wire_nbytes(n, wd)
        for r, out in g_outs.items():
            kv = out["kv"]
            if kv["pushed_bytes"] != kv["push_count"] * per_push or kv["push_count"] != steps:
                raise AssertionError(f"{label}: worker {r} pushed {kv['pushed_bytes']} "
                                     f"B in {kv['push_count']} pushes, cost model "
                                     f"{per_push} B per push")
        log(f"{label}: losses {[round(x, 6) for x in gl]} metrics "
            f"{[g_outs[r]['metrics'] for r in (0, 1)]} card within rtol 1e-4 of cpu; "
            f"exit records, degraded {g_stats['degraded_syncs']} / late "
            f"{g_stats['late_pushes']} / live {g_stats['live']} equal; {per_push} B "
            f"per push == ps_wire_nbytes({n}, {wd}); launches {g_got}")


class _NetRecorder:
    """For one [net] run: the server's Elastic1 and the worker's Elastic2
    operands of the last exchange (``core.kvstore.elastic_server_packed``
    and ``net.worker.elastic_client_packed`` wrapped), each exchange's and
    each step's wall time per worker, and (dist_sgd) the pushes the
    server decoded per round."""

    def __init__(self, dev):
        self.dev = dev
        self.server = self.client = None
        self.exchange_ms, self.step_ms, self.pushes = [], [], {}
        self._orig = (kvstore_mod.elastic_server_packed, net_worker.elastic_client_packed,
                      net_remote.RemoteKVStore.elastic_exchange)

    def _server(self, pushed, center, alpha):
        self.server = (pushed, center, alpha)
        return self._orig[0](pushed, center, alpha)

    def _client(self, params, center, alpha):
        self.client = (params, center, alpha)
        return self._orig[1](params, center, alpha)

    def tap(self, op, meta, payload):
        if op == "push":
            self.pushes[(int(meta["step"]), int(meta["unit"]))] = \
                net_wire.decode_buffer(meta, payload, self.dev)

    def __enter__(self):
        rec, exchange = self, self._orig[2]

        def timed(rkv, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exchange(rkv, *a, **kw)
            torch.cuda.synchronize()
            rec.exchange_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        kvstore_mod.elastic_server_packed = self._server
        net_worker.elastic_client_packed = self._client
        net_remote.RemoteKVStore.elastic_exchange = timed
        return self

    def __exit__(self, *exc):
        (kvstore_mod.elastic_server_packed, net_worker.elastic_client_packed,
         net_remote.RemoteKVStore.elastic_exchange) = self._orig


def _net_worker(tier, cfg, prob, dev, rank, rec) -> dict:
    """``run_worker``'s set-up (join, wait for the servers, a
    RemoteKVStore on ``dev``), then the port's own mode loop with the
    [net] problem; each step's wall time goes to ``rec.step_ms``."""
    tr = tier.tr
    conn = net_transport.connect_with_retry(tr, tier.addr)
    reply = net_rdzv.join_rendezvous(conn, "worker", rank)
    wcfg = net_rdzv.algo_from_dict(reply["config"]["algo"])
    addrs = net_rdzv.wait_servers(conn)
    rkv = net_remote.RemoteKVStore({r: tr.connect(a) for r, a in addrs.items()},
                                   wire_dtype=wcfg.effective_wire_dtype, device=dev)
    run = net_worker._run_dist_sgd if wcfg.mode == "dist_sgd" else net_worker._run_dist_esgd
    last = [time.perf_counter()]

    def flush(partial):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec.step_ms.append((now - last[0]) * 1e3)
        last[0] = now

    def killed():
        raise net_worker.WorkerKilled(rank)

    try:
        out = run(wcfg, prob, rkv, conn, rank, None, killed, flush=flush)
        out["kv"] = rkv.stats()
        return out
    finally:
        conn.request("leave", {"rank": rank})
        conn.close()
        rkv.close()


def _net_split(spec, dev, wd, params, center, alpha) -> dict:
    """One exchange's pieces at the [net] buffer, each timed alone (host
    clock around work that ends in a sync; median of 3): the worker's pack
    + encode (the device-to-host copy included), the TCP round trip of
    that payload through an echo server, the server's decode + host-to-
    device copy, the server kernel, the encode of the old center, and the
    worker's decode + Elastic2."""
    def host_ms(fn, reps=3):
        fn()
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    a = torch.tensor(float(alpha), device=dev)
    c = spec.pack(center)
    meta, payload = net_wire.encode_buffer(spec.pack(params), wd)
    tr = net_transport.transport_for("tcp")
    echo = tr.serve(lambda op, m, p: ({}, p))
    conn = tr.connect(echo.addr)
    try:
        out = {
            "pack_encode_ms": host_ms(lambda: net_wire.encode_buffer(spec.pack(params), wd)),
            "socket_round_trip_ms": host_ms(lambda: conn.request("echo", meta, payload)),
            "server_decode_ms": host_ms(lambda: net_wire.decode_buffer(meta, payload, dev)),
        }
        w = net_wire.decode_buffer(meta, payload, dev)
        out["server_kernel_ms"] = cuda_ms(lambda: fe.elastic_server_flat(w, c, a), reps=5)
        out["encode_center_ms"] = host_ms(lambda: net_wire.encode_buffer(c, wd))
        cmeta, cpayload = net_wire.encode_buffer(c, wd)
        out["worker_decode_elastic2_ms"] = host_ms(lambda: net_worker.elastic_client_packed(
            params, spec.unpack(net_wire.decode_buffer(cmeta, cpayload, dev)), alpha))
    finally:
        conn.close()
        echo.close()
    out["payload_bytes"] = len(payload)
    out["exchange_sum_ms"] = sum(v for k, v in out.items() if k.endswith("_ms"))
    # the payload crosses the loopback socket twice per round trip
    out["socket_MB_per_s"] = 2 * len(payload) / out["socket_round_trip_ms"] / 1e3
    return out


def _net_busy(tier, cfg, prob, dev, params, batch) -> tuple:
    """One more completion against the run's live server under the
    profiler — fwd + bwd, the socket exchange and Elastic2 (dist_esgd) or
    the push of a round no other worker joins (dist_sgd: its pull would
    wait for them), the fused update: (busy share, busy ms, wall ms)."""
    tr = tier.tr
    conn = tr.connect(tier.served[1].addr)
    rkv = net_remote.RemoteKVStore({0: conn}, wire_dtype=cfg.effective_wire_dtype,
                                   device=dev)
    key = "centers" if cfg.mode == "dist_esgd" else "grads"
    rkv.register(key, params)
    opt = alg._make_opt(cfg, params)
    state = opt.init(params)

    def completion(*_):
        _, g = prob.grad_fn(params, batch)
        if cfg.mode == "dist_esgd":
            old, _ = rkv.elastic_exchange(key, params, step=99, unit=0)
            p = net_worker.elastic_client_packed(params, old, cfg.esgd_alpha)
        else:
            rkv.push(key, g, step=99, unit=0)
            p = params
        opt.update(g, state, p)

    try:
        return _device_busy(completion, None, None)
    finally:
        rkv.close()


def phase_net(dev, card) -> tuple[dict, dict, dict]:
    """The paper-scale ResNet (21,788,200 f32 params in a 21,789,696-value
    FlatBuffer) through the socket PS tier: 2 worker threads (one client
    each) and one KVServer holding the center on the card, over TCP on
    127.0.0.1 — dist_esgd over int8 then f32 (4 steps, an exchange every
    step), then dist_sgd at f32 (3 steps). Launch counts, every SGD launch
    held on its own operands, the last exchange's Elastic1 / Elastic2 ==
    their plain versions on their own operands, each dist_sgd round's sum
    == the plain ascending-unit sum of its pushes, bytes per push and per
    reply == the cost model, the loss on the first step's images below its
    start (64 held-out images reported); the exchange split, socket MB/s,
    step and exchange ms, peak memory, busy share."""
    cfg_r = RESNET_PAPER
    t0 = time.perf_counter()
    pipes = [ImagePipeline(DataConfig(seed=0, batch_size=NET_BATCH, steps_per_epoch=4,
                                      shard=w), image_size=cfg_r.image_size,
                           num_classes=cfg_r.num_classes, device=dev) for w in range(2)]
    test = ImagePipeline(DataConfig(seed=0, batch_size=RESNET_EVAL_BATCH,
                                    steps_per_epoch=1, shard=999),
                         image_size=cfg_r.image_size, num_classes=cfg_r.num_classes,
                         device=dev).batch_at(99, 0)
    # the loss the run must lower: the 32 images of both workers' first
    # step (1000 classes: 64 held-out images move by noise after 128
    # training images, so their loss is reported, not gated)
    probe = {k: torch.cat([p.batch_at(0, 0)[k] for p in pipes]) for k in ("images",
                                                                       "labels")}
    log(f"[net] paper-scale ResNet {cfg_r}: 2 worker threads x {NET_BATCH} images, one "
        f"KVServer on the card, TCP on 127.0.0.1; pipelines drawn in "
        f"{time.perf_counter() - t0:.2f} s host")

    @torch.no_grad()
    def evaluate(params, batch=probe) -> float:
        return float(resnet_loss(params, batch, cfg_r)[0])

    prob = net_problem.Problem(
        "resnet-paper", lambda gen: init_resnet(gen, cfg_r, dev),
        hyb.make_grad_fn(cfg_r), evaluate, lambda w: pipes[w])
    params0 = prob.init_fn(torch.Generator().manual_seed(0))
    spec = flatbuf.spec_for(params0)
    if spec.payload != RESNET_PARAMS or spec.size != RESNET_FLAT:
        raise AssertionError(f"[net] FlatBuffer {spec.payload} / {spec.size}, want "
                             f"{RESNET_PARAMS} / {RESNET_FLAT}")
    start, start_held = evaluate(params0), evaluate(params0, test)
    launches, errs, report = {}, {}, {}
    for mode, wd, steps in NET_RUNS:
        cfg = alg.AlgoConfig(mode=mode, **NET_RUN, steps_per_epoch=steps,
                             policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                     wire_dtype=wd))
        label = f"[net] {mode} wire={wd or 'f32'}"
        rec = _NetRecorder(dev)
        tier = _NetTier(cfg, dev, tap=rec.tap if mode == "dist_sgd" else None)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with rec, _KernelHold() as hold:
                t0 = time.perf_counter()
                outs = _net_threads(lambda r: _net_worker(tier, cfg, prob, dev, r, rec),
                                    [0, 1])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            got = {k: v for k, v in counts(ALL_KERNELS).items() if v}
            hop = _hop_launches(label, _net_hop_want(steps) if wd == "int8" else None)
            peak = torch.cuda.max_memory_allocated()
            stats = tier.stats()
            # the center the server ends with (dist_sgd: the params every
            # worker ends with, equal by the barrier)
            final_params = (spec.unpack(tier.kv.kv.value("centers")) if mode == "dist_esgd"
                            else None)
            final = (evaluate(final_params) if final_params is not None
                     else outs[0]["metrics"][-1])
            held_out = (evaluate(final_params, test) if final_params is not None
                        else None)
            log(f"{label}: losses {[[round(x, 5) for x in o['losses']] for o in outs.values()]}"
                f"; loss on the first step's 32 images {start:.5f} -> {final:.5f}"
                + (f"; on 64 held-out images {start_held:.5f} -> {held_out:.5f}"
                   if held_out is not None else "") + f"; launches {got}, per-hop "
                f"codec {hop}")
            want = _net_want(mode, steps)
            if got != want:
                raise AssertionError(f"{label}: launches {got}, want {want}")
            if mode == "dist_esgd" and wd == "int8":
                launches = dict(want)
            per = cost_model.ps_wire_nbytes(spec.size, wd)
            pushes = 0
            for r, out in outs.items():
                kv = out["kv"]
                pushes += kv["push_count"]
                if (kv["push_count"] != steps or kv["pushed_bytes"] != steps * per
                        or kv["pulled_bytes"] != steps * per):
                    raise AssertionError(f"{label}: worker {r} {kv}, cost model {per} B "
                                         f"per push and per reply")
                losses = out["losses"]
                if not all(math.isfinite(x) for x in losses + out["metrics"]):
                    raise AssertionError(f"{label}: non-finite {losses} {out['metrics']}")
            if mode == "dist_sgd" and outs[0]["metrics"] != outs[1]["metrics"]:
                raise AssertionError(f"{label}: the workers' params differ: "
                                     f"{outs[0]['metrics']} {outs[1]['metrics']}")
            if not final < start:
                raise AssertionError(f"{label}: the eval loss {final} is not below its "
                                     f"start {start}")
            b = stats["bytes"]
            moved_in = b["exchange_in"] + b["push_in"]
            moved_out = b["exchange_out"] + b["pull_out"]
            if moved_in != pushes * per or moved_out != pushes * per:
                raise AssertionError(f"{label}: server bytes {b}, want {pushes} x {per}")
            held = {"sgd_momentum_flat": hold.err["sgd_momentum_flat"]}
            if mode == "dist_esgd":
                w, c, a = rec.server
                held["elastic_server_flat"] = _hold_ps(
                    "elastic_server_flat", (w, c, torch.tensor(float(a), device=dev)))
                params, center, a = rec.client
                held["elastic_client_flat"] = _hold_ps(
                    "elastic_client_flat", (spec.pack(params), spec.pack(center),
                                            torch.tensor(float(a), device=dev)))
            else:
                for s in range(steps):
                    meta, payload = tier.kv.handle("pull", {"key": "grads", "step": s}, b"")
                    total = net_wire.decode_buffer(meta, payload, dev)
                    plain = rec.pushes[(s, 0)] + rec.pushes[(s, 1)]
                    if not torch.equal(total, plain):
                        raise AssertionError(f"{label}: round {s}'s sum != the plain "
                                             f"ascending-unit sum of its pushes")
                held["round_sums"] = 0.0
            for name, e in held.items():
                if name in ALL_KERNELS:
                    errs[name] = max(errs.get(name, 0.0), e)
            split = (_net_split(spec, dev, wd, rec.client[0], rec.client[1],
                                cfg.esgd_alpha) if mode == "dist_esgd" else None)
            busy = _net_busy(tier, cfg, prob, dev, params0, pipes[0].batch_at(0, 0))
        finally:
            tier.close()
        ex = rec.exchange_ms
        report[label] = {
            "losses": {r: o["losses"] for r, o in outs.items()},
            "eval": [start, final], "held_out_eval": [start_held, held_out],
            "launches": got,
            "bytes_per_push": per, "pushes": pushes, "server_bytes": stats["bytes"],
            "run_ms": wall_ms, "step_ms": rec.step_ms, "exchange_ms": ex,
            "peak_mem_bytes": peak, "split": split,
            "device_busy_share": busy[0], "device_busy_ms": busy[1], "profiled_ms": busy[2],
            "holds": held, "card": card}
        log(f"{label}: {pushes} pushes x {per} B each way == ps_wire_nbytes({spec.size}, {wd}) "
            f"(server in {moved_in} / out {moved_out} B); holds == plain {held}")
        log(f"{label}: run {wall_ms:.0f} ms; step ms (every SGD launch's hold "
            f"included) {_ms_stats(rec.step_ms)}"
            + (f"; exchange ms {_ms_stats(ex)}" if ex else "")
            + f"; peak {peak / 2**30:.2f} GiB; busy {busy[1]} of {busy[2]:.1f} ms "
            f"profiled (share {busy[0]}) | {card}")
        if split is None:
            del rec, outs, hold
            torch.cuda.empty_cache()
            continue
        log(f"{label}: split (ms): pack+encode {split['pack_encode_ms']:.2f}, socket round "
            f"trip {split['socket_round_trip_ms']:.2f}, server decode+H2D "
            f"{split['server_decode_ms']:.2f}, server kernel {split['server_kernel_ms']:.3f}, "
            f"encode old center {split['encode_center_ms']:.2f}, worker decode+Elastic2 "
            f"{split['worker_decode_elastic2_ms']:.2f} (sum {split['exchange_sum_ms']:.1f}); "
            f"loopback TCP {split['socket_MB_per_s']:.0f} MB/s | {card}")
        del rec, outs, hold
        torch.cuda.empty_cache()
    del pipes
    return launches, errs, report


# ---------------------------------------------------------------------------
# phase 13: the launch tier — run_local's worker and server processes, and
# the launcher's autotuned full-width client command
# ---------------------------------------------------------------------------

#: [launch:small]: logreg8, 2 worker processes + 1 server process
LAUNCH_RUN = dict(mode="dist_sgd", num_workers=2, num_clients=2, num_servers=1,
                  lr=0.05, epochs=1, steps_per_epoch=3, seed=0, compute_time=0.0,
                  jitter=0.0)
#: the dist_esgd job: 2 epochs of 2 steps, an exchange every step, int8 wire
LAUNCH_ESGD = dict(LAUNCH_RUN, mode="dist_esgd", lr=0.1, momentum=0.9, epochs=2,
                   steps_per_epoch=2, esgd_interval=1)
#: barrier timeout of the faulted jobs: a deadlock guard the holds never
#: wait on (a respawn rejoins within seconds)
LAUNCH_GUARD_S = 120.0
LAUNCH_JOB_S = 300.0
#: [launch]: a pure-MPI job of 8 workers in one client, the policy ranked
#: at p = 8 devices per client; one rank of its command at full width
LAUNCH_ARGV = ["--arch", "qwen2-0.5b", "--workers", "8", "--servers", "0",
               "--clients", "1", "--policy", "auto"]
LAUNCH_STEPS = 3
GEMM_N = 8192
#: the port's entry points a job's child processes run
CHILD_ENTRIES = ("repro_torch.launch.train", "repro_torch.net.kvserver")


class _ChildWatch:
    """While a job runs: every 0.1 s, each process whose command line runs
    a port entry point — its unit (REPRO_ROLE / REPRO_RANK from its
    environment) and whether it holds a ``/dev/nvidia*`` file open (a
    CUDA context); every 0.5 s, nvidia-smi's compute apps (pid, MiB) and
    the card's used memory (MiB)."""

    def __init__(self):
        self.units, self.card, self.smi, self.used_mib = {}, set(), {}, []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._loop, args=(f, s), daemon=True)
                         for f, s in ((self._scan, 0.1), (self._query, 0.5))]

    def _loop(self, fn, every):
        while not self._stop.is_set():
            fn()
            self._stop.wait(every)

    def _scan(self):
        for pid in os.listdir("/proc"):
            if not pid.isdigit() or int(pid) == os.getpid():
                continue
            try:
                cmd = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode()
                if not any(e in cmd for e in CHILD_ENTRIES):
                    continue
                env = dict(kv.split(b"=", 1) for kv in
                           Path(f"/proc/{pid}/environ").read_bytes().split(b"\0") if b"=" in kv)
                fds = [os.readlink(f"/proc/{pid}/fd/{fd}")
                       for fd in os.listdir(f"/proc/{pid}/fd")]
            except (OSError, ValueError):
                continue              # the process ended between two reads
            role = env.get(b"REPRO_ROLE", b"?").decode()
            self.units[int(pid)] = (f"{'client' if role == 'worker' else role}_"
                                    f"{env.get(b'REPRO_RANK', b'?').decode()}")
            if any(f.startswith("/dev/nvidia") for f in fds):
                self.card.add(int(pid))

    def _query(self):
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True).stdout
        for line in out.strip().splitlines():
            pid, _, mib = line.partition(",")
            if pid.strip().isdigit():
                self.smi[int(pid)] = mib.strip()
        used = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                               "--format=csv,noheader,nounits"],
                              capture_output=True, text=True).stdout.split()
        if used and used[0].isdigit():
            self.used_mib.append(int(used[0]))

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(5.0)

    def on_card(self, units) -> dict:
        """{unit: [pids seen holding the card]}; raises unless every unit
        of ``units`` had a process with a CUDA context open."""
        got = {u: sorted(p for p, v in self.units.items() if v == u and p in self.card)
               for u in units}
        missing = [u for u, pids in got.items() if not pids]
        if missing:
            raise AssertionError(f"[launch:small] no process of {missing} held the card "
                                 f"(seen: {self.units}, with /dev/nvidia*: {sorted(self.card)})")
        return got


def _startup_s(env) -> float:
    """Wall seconds for a fresh interpreter to import the port's worker and
    put a tensor on the card: the start-up every child process pays."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c",
                    "import torch, repro_torch.launch.train, repro_torch.net.worker; "
                    "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"],
                   env=env, check=True, timeout=300)
    return time.perf_counter() - t0


def _job(label, algo, outdir, **kw):
    """One ``run_local.run_job``, its wall seconds logged."""
    t0 = time.perf_counter()
    res = run_local.run_job(algo, outdir=str(outdir) if outdir else None,
                            timeout=LAUNCH_JOB_S, **kw)
    wall = time.perf_counter() - t0
    history = f" (history {res.exit_history})" if res.respawns else ""
    log(f"{label}: {wall:.1f} s wall, exit codes {res.exit_codes}{history}, "
        f"losses {res.losses} metrics {res.metrics}")
    return res, wall


def _same_curve(label, got, want) -> None:
    if got.losses != want.losses or got.metrics != want.metrics:
        raise AssertionError(f"{label}: losses {got.losses} metrics {got.metrics} != "
                             f"{want.losses} / {want.metrics}")


def phase_launch_small(dev, card) -> dict:
    """``run_local.run_job`` on logreg8 with 2 worker processes and 1 server
    process, spawned from the launcher's scripts under the supervisor, TCP
    on 127.0.0.1 — card processes == loopback threads on the card; CPU
    processes within rtol 1e-4; a worker killed and respawned and the
    server killed and restored, both == the clean job; dist_esgd over the
    int8 wire by exit codes, exchanges, bytes and finite losses."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log(f"[launch:small] compute mode {mode!r}; python on PATH "
        f"{shutil.which('python')!r}, the scripts' python -> {sys.executable} | {card}")
    if "Exclusive" in mode:
        raise AssertionError(f"[launch:small] compute mode {mode}: one CUDA context per "
                             "card, so the job's worker and server processes cannot share it")
    root = ROOT / "build" / "launch_small"
    shutil.rmtree(root, ignore_errors=True)
    env = run_local._child_env(str(root))
    start = [_startup_s(env)]
    log(f"[launch:small] process start-up (interpreter, port import, CUDA context): "
        f"{[round(s, 2) for s in start]} s | {card}")
    report = {"compute_mode": mode, "startup_s": start, "wall_s": {}}
    sgd = alg.AlgoConfig(**LAUNCH_RUN)
    units = ("client_0", "client_1", "server_0")

    reset_counts()
    with _ChildWatch() as idle:
        time.sleep(1.0)
    with _ChildWatch() as watch:
        clean, report["wall_s"]["card"] = _job("[launch:small] dist_sgd card processes",
                                               sgd, root / "card", device="cuda")
    got = {k: v for k, v in counts(ALL_KERNELS).items() if v}
    if got:
        raise AssertionError(f"[launch:small] the children's launches reached this "
                             f"process: {got}")
    on_card = watch.on_card(units)
    # nvidia-smi names processes by the host's pids: it lists this
    # process's own pid only where it shares the host's pid namespace
    own = os.getpid() in watch.smi or os.getpid() in idle.smi
    in_smi = {u: [(p, watch.smi[p]) for p in pids if p in watch.smi]
              for u, pids in on_card.items()}
    log(f"[launch:small] child pids holding the card (/proc fds): {on_card}; "
        f"nvidia-smi's compute apps (pid, MiB) during the job {watch.smi}, this "
        f"process ({os.getpid()}) {'listed' if own else 'not listed: another pid namespace'}"
        f"; the children in it {in_smi}; card memory used {idle.used_mib[-1:]} MiB idle, "
        f"{max(watch.used_mib, default=None)} MiB at most during the job | {card}")
    if own and not all(in_smi.values()):
        raise AssertionError(f"[launch:small] nvidia-smi lists {sorted(watch.smi)} "
                             f"but not every child {on_card}")
    report.update(child_pids=on_card, smi=watch.smi, own_pid_in_smi=own,
                  used_mib_idle=idle.used_mib, used_mib_job_max=max(watch.used_mib,
                                                                     default=None))
    if clean.exit_codes != {"server_0": 0, "client_0": 0, "client_1": 0} \
            or len(clean.losses) != 3 or clean.degraded_syncs:
        raise AssertionError(f"[launch:small] clean job: {clean.exit_codes}, "
                             f"{clean.losses}, degraded {clean.degraded_syncs}")

    # the other five jobs side by side (each is mostly its processes'
    # start-up): four of processes in threads, the loopback job's threads
    # in this one, whose launches are the only ones counted here
    jobs = {
        "cpu": ("[launch:small] dist_sgd CPU processes", sgd, root / "cpu",
                dict(device="cpu")),
        "respawn": ("[launch:small] worker 1 killed at step 2 and respawned",
                    alg.AlgoConfig(**LAUNCH_RUN, faults="kill@2:unit=1;restart@2:unit=1",
                                   checkpoint_every=1, barrier_timeout=LAUNCH_GUARD_S),
                    root / "respawn", dict(device="cuda")),
        "restore": ("[launch:small] server killed after step 1 and restored",
                    alg.AlgoConfig(**LAUNCH_RUN,
                                   server_faults="kill@1:unit=0;restart@1:unit=0",
                                   checkpoint_every=1, barrier_timeout=LAUNCH_GUARD_S),
                    root / "restore", dict(device="cuda")),
        "esgd_int8": ("[launch:small] dist_esgd int8 card processes",
                      alg.AlgoConfig(**LAUNCH_ESGD, policy=CollectivePolicy(
                          method="multi_ring", num_rings=2, wire_dtype="int8")),
                      root / "esgd", dict(device="cuda")),
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_job, label, algo, outdir, **kw)
                   for k, (label, algo, outdir, kw) in jobs.items()}
        reset_counts()
        loop, report["wall_s"]["loopback"] = _job(
            "[launch:small] dist_sgd loopback threads on the card", sgd, None,
            transport="loopback", device="cuda")
        torch.cuda.synchronize()
        got = {k: v for k, v in counts(ALL_KERNELS).items() if v}
        done = {k: f.result() for k, f in futures.items()}
    report["wall_s"]["side_by_side"] = time.perf_counter() - t0
    log(f"[launch:small] the five jobs side by side took "
        f"{report['wall_s']['side_by_side']:.1f} s | {card}")
    for k, (_, wall) in done.items():
        report["wall_s"][k] = wall
    host, kill, srv, ex = (done[k][0] for k in ("cpu", "respawn", "restore", "esgd_int8"))
    if got != {"sgd_momentum_flat": 6}:
        raise AssertionError(f"[launch:small] loopback launches {got}, want 6 sgd")
    _same_curve("[launch:small] card processes vs loopback threads", clean, loop)

    torch.testing.assert_close(torch.tensor(host.losses), torch.tensor(clean.losses),
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(torch.tensor(host.metrics), torch.tensor(clean.metrics),
                               rtol=1e-4, atol=0)
    _same_curve("[launch:small] respawn", kill, clean)
    if kill.exit_history.get("client_1") != [137, 0] or kill.degraded_syncs:
        raise AssertionError(f"[launch:small] respawn: exit history "
                             f"{kill.exit_history}, degraded {kill.degraded_syncs}")
    _same_curve("[launch:small] restore", srv, clean)
    restored = srv.server_stats[0].get("restored_step")
    if restored is None or restored < 1 or srv.degraded_syncs:
        raise AssertionError(f"[launch:small] restore: restored step {restored}, "
                             f"degraded {srv.degraded_syncs}")

    n = flatbuf.spec_for(net_problem.build_problem("logreg8", device="cpu").init_fn(
        torch.Generator().manual_seed(0))).size
    per_push = cost_model.ps_wire_nbytes(n, "int8")
    if set(ex.exit_codes.values()) != {0}:
        raise AssertionError(f"[launch:small] dist_esgd exit codes {ex.exit_codes}")
    for r in (0, 1):
        out, kv = ex.per_worker[r], ex.per_worker[r]["kv"]
        if (out["exchanges"] != 4 or kv["push_count"] != 4
                or kv["pushed_bytes"] != 4 * per_push or kv["pulled_bytes"] != 4 * per_push):
            raise AssertionError(f"[launch:small] dist_esgd worker {r}: exchanges "
                                 f"{out['exchanges']}, kv {kv}, want 4 x {per_push} B")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"[launch:small] dist_esgd worker {r} losses {out['losses']}")
    log(f"[launch:small] holds: card processes == loopback threads on the card "
        f"(losses {clean.losses}, metrics {clean.metrics}); CPU processes within "
        f"rtol 1e-4; respawn exit history {kill.exit_history['client_1']} and restore "
        f"(restored step {restored}) == the clean job, 0 degraded; dist_esgd int8 4 "
        f"exchanges a worker, {per_push} B per push and per reply == "
        f"ps_wire_nbytes({n}, int8), exit codes {ex.exit_codes} | {card}")
    return report


def phase_launch(dev, card, sgd_row) -> tuple[int, float, dict]:
    """The launcher's ``main`` with ``--policy auto`` emits a pure-MPI job
    of qwen2-0.5b; one rank of its ``client_0.sh`` command runs here, at
    full width, 3 steps through ``launch.train.main`` (the launches
    counted), the SGD kernel held on one more step's operands; and the
    card's bf16 GEMM and stream rates beside ``analysis``'s data sheet
    ones. -> (sgd launches, hold max_abs_err, report)."""
    import contextlib
    import io
    import shlex

    outdir = ROOT / "build" / "launch_scripts"
    shutil.rmtree(outdir, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.main(LAUNCH_ARGV + ["--outdir", str(outdir)])
    for line in buf.getvalue().splitlines():
        log(f"[launch] launcher: {line}")
    job = json.loads((outdir / "job_spec.json").read_text())
    cfg = get_config("qwen2-0.5b")
    shape = INPUT_SHAPES["train_4k"]
    want = autotune.autotune_for_model(cfg, p=8,
                                       tokens_per_step=shape.seq_len * shape.global_batch)
    chosen = want.chosen.policy
    if job["sync"]["policy"] != chosen.to_dict() or "# --policy auto" not in buf.getvalue():
        raise AssertionError(f"[launch] the job's policy {job['sync']['policy']} is not "
                             f"the autotuned {chosen.to_dict()}")
    script = launcher.parse_script(str(outdir / "client_0.sh"))
    toks = shlex.split(script["cmd"])
    if toks[:6] != ["mpirun", "-np", "8", "python", "-m", "repro_torch.launch.train"]:
        raise AssertionError(f"[launch] client_0.sh runs {script['cmd']!r}")
    argv = toks[6:] + ["--full-size", "--steps", str(LAUNCH_STEPS)]
    log(f"[launch] chosen policy {chosen.to_dict()} ({want.chosen.bytes_per_step:,.0f} "
        f"wire B / step modeled at p = 8); one rank of client_0.sh: train.main({argv})")

    marks, captured = [], {}
    orig = train_mod.train_loop

    def traced_loop(model, optimizer, sync, mesh, batches, **kw):
        def mark(entry):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        marks.append(time.perf_counter())
        state, hist = orig(model, optimizer, sync, mesh, batches, callback=mark, **kw)
        captured.update(model=model, optimizer=optimizer, sync=sync, state=state)
        return state, hist

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    train_mod.train_loop = traced_loop
    reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            hist = train_mod.main(argv)
        torch.cuda.synchronize()
    finally:
        train_mod.train_loop = orig
    got = counts(ALL_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    for line in buf.getvalue().splitlines():
        log(f"[launch] train: {line}")
    _check_launches("[launch]", got, {"sgd_momentum_flat": LAUNCH_STEPS}, LAUNCH_STEPS)
    header = next(l for l in buf.getvalue().splitlines() if l.startswith("[train] client"))
    named = (f"wire_dtype={chosen.wire_dtype or 'f32'} ", f"overlap={chosen.overlap} ",
             f"overlap_buckets={chosen.overlap_buckets} ")
    sync = captured["sync"]
    if not all(n in header for n in named) or sync.policy != chosen:
        raise AssertionError(f"[launch] the run's policy {sync.policy} / header {header!r} "
                             f"is not the chosen {chosen}")
    losses = [h["loss"] for h in hist]
    if len(losses) != LAUNCH_STEPS or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"[launch] losses {losses}: want {LAUNCH_STEPS}, finite, falling")
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=64, batch_size=8,
                                    steps_per_epoch=LAUNCH_STEPS), device=dev)
    step = make_train_step(captured["model"], captured["optimizer"], sync, device=dev)
    with _KernelHold() as hold:           # one more step, not counted
        step(captured["state"], pipe.batch_at(0, 0))
    torch.cuda.synchronize()
    err = hold.err["sgd_momentum_flat"]
    del captured, step
    torch.cuda.empty_cache()

    a = torch.randn(GEMM_N, GEMM_N, device=dev, dtype=torch.bfloat16)
    b = torch.randn(GEMM_N, GEMM_N, device=dev, dtype=torch.bfloat16)
    gemm_ms = cuda_ms(lambda: torch.matmul(a, b), reps=20, warmup=3)
    gemm = 2 * GEMM_N ** 3 / (gemm_ms * 1e-3)
    del a, b
    stream = sgd_row["bytes"] / (sgd_row["ms"] * 1e-3)
    report = {"policy": chosen.to_dict(), "argv": argv, "losses": losses,
              "step_ms": step_ms, "peak_mem_bytes": peak, "hold_max_abs_err": err,
              "gemm_ms": gemm_ms, "gemm_flops_per_s": gemm,
              "stream_bytes_per_s": stream, "peak_flops": analysis.PEAK_FLOPS,
              "hbm_bw": analysis.HBM_BW}
    log(f"[launch] full-width qwen2-0.5b under the autotuned policy: losses "
        f"{[round(x, 4) for x in losses]} falling; init + step 1 {step_ms[0]:.1f} ms, steps "
        f"{[round(x, 1) for x in step_ms[1:]]} ms; peak {peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in got.items() if v} }; kernel hold ({'; '.join(hold.calls)}) "
        f"== plain: max_abs_err {err} | {card}")
    log(f"[launch] rates: bf16 GEMM {GEMM_N}^3 {gemm_ms:.3f} ms = {gemm / 1e12:.1f} TFLOP/s "
        f"against analysis.PEAK_FLOPS {analysis.PEAK_FLOPS / 1e12:.0f} "
        f"({gemm / analysis.PEAK_FLOPS:.1%}); stream (phase 2 sgd_momentum_flat, "
        f"{sgd_row['bytes']} B in {sgd_row['ms']:.4f} ms) {stream / 1e12:.3f} TB/s against "
        f"analysis.HBM_BW {analysis.HBM_BW / 1e12:.2f} ({stream / analysis.HBM_BW:.1%}) "
        f"| {card}")
    return got["sgd_momentum_flat"], err, report


# ---------------------------------------------------------------------------
# phase 14: the process mesh — the shard driver as one process per rank
# ---------------------------------------------------------------------------

MESH_STEPS = 3
#: [mesh:small]: the reduced model, each layout's cases in one spawn of
#: gloo ranks on the card (the (2, 2) mpi_esgd cases exchange at steps 0
#: and 2); a ``drive`` case goes through the entry point ``drive(mesh=)``
#: from the seed-1 init instead of ``make_sharded_step`` on given params
MESH_SMALL = {
    (4,): [dict(mode="mpi_sgd", opt="sgd"), dict(mode="mpi_sgd", opt="adamw"),
           dict(mode="mpi_sgd", opt="adagrad"),
           dict(mode="mpi_sgd", opt="sgd", wire="int8"),
           dict(mode="mpi_sgd", opt="sgd", wire="bf16"),
           dict(mode="mpi_sgd", opt="sgd", overlap=True)],
    (2, 2): [dict(mode="mpi_sgd", opt="sgd"), dict(mode="mpi_sgd", opt="adamw"),
             dict(mode="mpi_sgd", opt="adagrad"),
             dict(mode="mpi_esgd", opt="sgd", wire="int8", clients=2),
             dict(mode="mpi_esgd", opt="adamw", clients=2, drive=True)],
}
MESH_HYPER = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=3e-3),
              "adagrad": dict(lr=0.05)}
#: [mesh]: full width, p = 4, [overlap]'s momentum SGD without overlap
MESH_FULL = [dict(mode="mpi_sgd", opt="sgd", wire="int8", full=True),
             dict(mode="mpi_sgd", opt="sgd", full=True)]
#: the 1/4 shard of the full-width packed buffer at one ring, RUN_DEPTH layers
MESH_SHARD = 63_887_360


def _mesh_axes(shape) -> tuple:
    return ("dev",) if len(shape) == 1 else (sd.POD_AXIS, sd.DATA_AXIS)


def _mesh_case(case):
    """A case's model, optimizer and SyncConfig; the full-width cases are
    [overlap]'s runs without overlap."""
    cfg = _run_cfg() if case.get("full") else reduced(get_config("qwen2-0.5b"))
    model = build_model(cfg)
    hyper = dict(lr=ESGD_LR, momentum=0.9) if case.get("full") else MESH_HYPER[case["opt"]]
    opt = sgd_mod.get_optimizer(case["opt"], **hyper)
    if case.get("full"):
        return model, opt, _overlap_sync(case.get("wire"), overlap=False)
    overlap = bool(case.get("overlap"))
    return model, opt, SyncConfig(
        mode=case["mode"], num_clients=case.get("clients", 1), esgd_interval=2,
        esgd_alpha=0.5, policy=CollectivePolicy(
            method="ring", num_rings=1 if overlap else 2, wire_dtype=case.get("wire"),
            overlap=overlap, overlap_buckets=OVERLAP_BUCKETS))


def _mesh_label(shape, case) -> str:
    extra = [f"{k}={v}" for k, v in case.items()
             if k not in ("mode", "opt", "clients", "full", "drive")]
    return f"p={shape if len(shape) > 1 else shape[0]} {case['mode']} {case['opt']} " + \
        (" ".join(extra) or "f32") + (" via drive(mesh=)" if case.get("drive") else "")


class _LastLaunch:
    """Wraps the kernels the driver launches (the optimizer kernels as
    ``optim.sgd`` calls them, the exchange's two as ``core.elastic`` does)
    and keeps each one's last launch — its operands and outputs, which the
    path does not write again — for a hold after the run."""

    SITES = [(sgd_mod, n) for n in KERNELS] + [
        (elastic_mod, "elastic_client_diff_flat"), (elastic_mod, "elastic_center_flat")]

    def __init__(self):
        self.last = {}
        self._orig = {name: getattr(mod, name) for mod, name in self.SITES}

    def __enter__(self):
        for mod, name in self.SITES:
            orig = self._orig[name]

            def call(*args, _name=name, _orig=orig):
                out = _orig(*args)
                self.last[_name] = (args, out)
                return out

            setattr(mod, name, call)
        return self

    def __exit__(self, *exc):
        for mod, name in self.SITES:
            setattr(mod, name, self._orig[name])

    def hold(self) -> dict:
        """Each kept launch against its plain version on its own operands:
        phase 2's tolerances, ``elastic_center_flat`` ``==``; 1-D optimizer
        streams in 2^26-element pieces."""
        errs, shapes = {}, {}
        for name, (args, out) in self.last.items():
            if name in KERNELS:
                k = KERNELS[name]
                p, s_, g, hp = args
                if name == "adamw_flat":
                    rows = p.shape[0] if p.dim() == 2 else 1
                    v = lambda t, *sh: t.reshape(rows, *sh)
                    pieces = [(v(p, -1)[i], v(s_, 2, -1)[i], v(g, -1)[i],
                               v(out[0], -1)[i], v(out[1], 2, -1)[i]) for i in range(rows)]
                else:
                    pieces = [tuple(t.reshape(-1)[i:i + _KernelHold.PIECE]
                                    for t in (p, s_, g, *out))
                              for i in range(0, p.numel(), _KernelHold.PIECE)]
                err = 0.0
                for pp, ss, gg, op, os_ in pieces:
                    for got, want in zip((op, os_), k["plain"](pp, ss, gg, hp)):
                        torch.testing.assert_close(got, want, rtol=k["rtol"], atol=k["atol"])
                        err = max(err, float((got.float() - want.float()).abs().max()))
            else:
                k = ELASTIC_KERNELS[name]
                *ops, alpha = args
                rows = lambda t: t.reshape(-1, t.shape[-1])
                want = _plain_rows(k["plain"], tuple(rows(t) for t in ops), alpha)
                got = tuple(rows(t) for t in (out if isinstance(out, tuple) else (out,)))
                if k.get("exact"):
                    err = _hold_exact(name, got, want)
                else:
                    want = want if isinstance(want, tuple) else (want,)
                    err = max(_hold(g, w, k["rtol"], k["atol"], g.dtype)
                              for g, w in zip(got, want))
            errs[name] = err
            shapes[name] = tuple(args[0].shape)
        return {"hold_max_abs_err": errs, "hold_shapes": shapes}


class _MeshSplit:
    """A rank's step split: the grad fn (``stacked_grads``), the
    reduce-scatter and allgather legs (each with its ``Link`` share: the
    staged D2H and H2D copies and the send / receive), and the optimizer
    kernel (``optim.sgd._fused_shard_update``); host clock, the card
    synchronised on both sides of each."""

    def __init__(self, link):
        self.link, self.ms = link, {}
        self._sites = [(sd, "stacked_grads", "grad_fn"),
                       (Communicator, "reduce_scatter", "reduce_scatter"),
                       (Communicator, "allgather", "allgather"),
                       (sgd_mod, "_fused_shard_update", "kernel")]
        self._orig = {name: getattr(obj, name) for obj, name, _ in self._sites}

    def __enter__(self):
        for obj, name, key in self._sites:
            orig = self._orig[name]

            def timed(*args, _orig=orig, _key=key, **kw):
                st = self.link.stats
                before = (st.d2h_s, st.h2d_s, st.p2p_s, st.d2h_bytes, st.h2d_bytes)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*args, **kw)
                torch.cuda.synchronize()
                self.ms[_key] = self.ms.get(_key, 0.0) + (time.perf_counter() - t0) * 1e3
                after = (st.d2h_s, st.h2d_s, st.p2p_s, st.d2h_bytes, st.h2d_bytes)
                for tag, a, b in zip(("d2h_ms", "h2d_ms", "p2p_ms", "d2h_bytes",
                                      "h2d_bytes"), before, after):
                    scale = 1e3 if tag.endswith("_ms") else 1
                    if b != a:
                        k = f"{_key}.{tag}"
                        self.ms[k] = self.ms.get(k, 0) + (b - a) * scale
                return out

            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc):
        for obj, name, _ in self._sites:
            setattr(obj, name, self._orig[name])

    def take(self) -> dict:
        out, self.ms = self.ms, {}
        return out


def _nvidia_fds() -> int:
    """How many ``/dev/nvidia*`` files this process holds open."""
    fds = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            fds.append(os.readlink(f"/proc/self/fd/{fd}"))
        except OSError:
            continue
    return sum(f.startswith("/dev/nvidia") for f in fds)


def _mesh_rank(mesh, cases, params, batches) -> list:
    """One rank of phase 14 (a spawned process, the card shared): each
    case's driver state block (``make_driver_state(mesh=)``, the params
    and centers set to ``params`` when given, else the seed-0 init), then
    ``MESH_STEPS`` steps of ``make_sharded_step`` on its block of each
    batch — the launch counts set to 0 just before and read just after,
    the last launch of each kernel held against its plain version after
    the run, the wire bytes, the ``Link``'s staging, step ms and (at full
    width) its split, peak memory and the card's used MiB. A ``drive``
    case runs ``drive(mesh=)`` over the batches instead (its own seed-1
    init; the history's entries are its metrics, no wire meter)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, _ = sd._mesh_geometry(mesh)
    out = []
    for case in cases:
        model, opt, sync = _mesh_case(case)
        if case.get("drive"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mesh.link.stats.reset()
            with _LastLaunch() as last:
                reset_counts()
                state, hist = sd.drive(model, opt, sync, batches, mesh=mesh, seed=1,
                                       log_every=1)
                launches = counts(ALL_KERNELS)
            out.append(_mesh_rank_tail(mesh, case, state, last, {
                "losses": [h["loss"] for h in hist], "metrics": hist, "wire": None,
                "launches": launches}))
            continue
        state = sd.make_driver_state(model, opt, sync, mesh=mesh)
        if params is not None:
            for key in ("params", "center"):
                if key in state:
                    state[key] = tree_map(lambda t: t.to(mesh.device).unsqueeze(0).clone(),
                                          params)
        meter = WireMeter()
        step = sd.make_sharded_step(model, opt, sync, mesh, meter=meter)
        split = _MeshSplit(mesh.link)
        rec = {"losses": [], "metrics": [], "wire": [], "step_ms": [], "split": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.link.stats.reset()
        with _LastLaunch() as last, split:
            reset_counts()
            for b in batches:
                meter.reset()
                blk = sd.rank_block(sd.shard_batch(b, p), mesh)
                t0 = time.perf_counter()
                state, met = step(state, blk)
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["losses"].append(float(met["loss"]))
                rec["metrics"].append({k: v.cpu() for k, v in met.items()})
                rec["wire"].append(meter.bytes)
                rec["split"].append(split.take())
            rec["launches"] = counts(ALL_KERNELS)
        out.append(_mesh_rank_tail(mesh, case, state, last, rec))
        del state, step
    return out


def _mesh_rank_tail(mesh, case, state, last, rec) -> dict:
    """What a rank reports after a case's run: peak memory, the ``Link``'s
    staging, the card's used MiB with every rank's state alive, the held
    last launches, its ``/dev/nvidia*`` fds and (reduced) its state."""
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    st = mesh.link.stats
    rec["link"] = dict(messages=st.messages, d2h_bytes=st.d2h_bytes,
                       h2d_bytes=st.h2d_bytes, d2h_s=st.d2h_s, h2d_s=st.h2d_s,
                       p2p_s=st.p2p_s)
    torch.distributed.barrier()             # every rank holds its state
    free, total = torch.cuda.mem_get_info()
    rec["card_used_mib"] = (total - free) / 2**20
    torch.distributed.barrier()
    rec.update(last.hold())
    rec["nvidia_fds"] = _nvidia_fds()
    if not case.get("full"):
        rec["state"] = tree_map(lambda t: t.cpu(), state)
    torch.cuda.empty_cache()
    return rec


def _mesh_emulated(case, p, params, batches, dev) -> dict:
    """The same case through ``make_emulated_step`` on the card (a
    ``drive`` case through ``drive(p=)``)."""
    model, opt, sync = _mesh_case(case)
    if case.get("drive"):
        reset_counts()
        state, hist = sd.drive(model, opt, sync, batches, p=p, seed=1, device=dev,
                               log_every=1)
        return {"losses": [h["loss"] for h in hist], "metrics": hist, "wire": None,
                "launches": counts(ALL_KERNELS),
                "state": tree_map(lambda t: t.cpu(), state)}
    state = sd.make_driver_state(model, opt, sync, p, device=dev)
    n = state["step"].shape[0]
    for key in ("params", "center"):
        if key in state:
            state[key] = tree_map(lambda t: t.to(dev).unsqueeze(0).expand(
                (n,) + tuple(t.shape)).clone(), params)
    meter = WireMeter()
    step = sd.make_emulated_step(model, opt, sync, p, meter=meter)
    rec = {"losses": [], "metrics": [], "wire": []}
    reset_counts()
    for b in batches:
        meter.reset()
        state, met = step(state, sd.shard_batch(b, p))
        rec["losses"].append(float(met["loss"]))
        rec["metrics"].append({k: v.cpu() for k, v in met.items()})
        rec["wire"].append(meter.bytes)
    rec["launches"] = counts(ALL_KERNELS)
    rec["state"] = tree_map(lambda t: t.cpu(), state)
    return rec


def _mesh_want_launches(case, steps=MESH_STEPS) -> dict:
    """One optimizer launch a step per rank; the two exchange kernels
    once per exchange per rank (steps 0 and 2 at interval 2)."""
    want = {OPT_KERNEL[case["opt"]]: steps}
    if case["mode"] == "mpi_esgd":
        ex = len(range(0, steps, 2))
        want.update(elastic_client_diff_flat=ex, elastic_center_flat=ex)
    return want


def _mesh_compare(label, ranks, emu) -> str:
    """The rank blocks gathered against the emulated state, and every
    rank's metrics against the emulated ones: both ``==``, bit for bit
    on the card as on the CPU."""
    got = sd.gather_blocks([r["state"] for r in ranks])
    for key, tree in emu["state"].items():
        for a, b in zip(tree_leaves(got[key]), tree_leaves(tree), strict=True):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{label}: {key} layout {a.shape} {a.dtype} "
                                     f"!= {b.shape} {b.dtype}")
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{label}: {key} != emulated, max |diff| "
                    f"{float((a.float() - b.float()).abs().max()):.3e}")
    same = lambda a, b: torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    for r, rec in enumerate(ranks):
        for j, (mr, me) in enumerate(zip(rec["metrics"], emu["metrics"], strict=True)):
            if mr.keys() != me.keys() or not all(same(mr[k], me[k]) for k in me):
                raise AssertionError(f"{label} rank {r} step {j}: metrics {mr} != "
                                     f"emulated {me}")
    return "state and metrics == emulated"


def phase_mesh_small(dev, card) -> dict:
    """[mesh:small]: the reduced model's driver as gloo ranks on the card
    against the emulated driver on the card; then one NCCL rank."""
    cfg = reduced(get_config("qwen2-0.5b"))
    params = tree_map(lambda t: t.cpu(), build_model(cfg).init(device="cpu", seed=1))
    gen = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(MESH_STEPS):
        toks = torch.randint(0, 1024, (8, 32), generator=gen, dtype=torch.int32)
        batches.append({"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    spec = grad_spec(build_model(cfg))
    report = {}
    runs = [(shape, "gloo", cases, batches) for shape, cases in MESH_SMALL.items()]
    runs.append(((1,), "nccl", [dict(mode="mpi_sgd", opt="sgd")],
                 [{k: v[:2] for k, v in b.items()} for b in batches]))
    # every layout's spawn side by side, the NCCL rank's too (start-up
    # dominates them)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(runs)) as ex:
        futs = [ex.submit(run_mesh, shape, backend, cases, params, bs)
                for shape, backend, cases, bs in runs]
        spawned = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    for (shape, backend, cases, bs), ranks in zip(runs, spawned):
        torch.cuda.empty_cache()
        log(f"[mesh:small] {len(ranks)} {backend} rank(s) {shape} on the card: "
            f"{len(cases)} cases in {wall:.1f} s (spawn, start-up, runs; every layout "
            f"side by side) | {card}")
        p = shape if len(shape) > 1 else shape[0]
        for i, case in enumerate(cases):
            label = f"[mesh:small] {backend} {_mesh_label(shape, case)}"
            per_rank = [r[i] for r in ranks]
            emu = _mesh_emulated(case, p, params, bs, dev)
            verdict = _mesh_compare(label, per_rank, emu)
            want = _mesh_want_launches(case)
            for r, rec in enumerate(per_rank):
                _check_launches(f"{label} rank {r}", rec["launches"], want, MESH_STEPS)
                if rec["wire"] != emu["wire"]:
                    raise AssertionError(f"{label} rank {r}: wire {rec['wire']} != "
                                         f"emulated {emu['wire']}")
                if rec["nvidia_fds"] < 1:
                    raise AssertionError(f"{label} rank {r}: no /dev/nvidia* open")
                if set(rec["hold_max_abs_err"]) != set(want):
                    raise AssertionError(f"{label} rank {r}: held {rec['hold_max_abs_err']}")
            _, _, sync = _mesh_case(case)
            if not sync.overlap and not case.get("drive"):
                legs, exch = _wire_per_step(spec, sync, p)
                model_bytes = [legs + (exch if j % 2 == 0 else 0) for j in range(MESH_STEPS)]
                if emu["wire"] != model_bytes:
                    raise AssertionError(f"{label}: wire {emu['wire']} != cost model "
                                         f"{model_bytes}")
            staged = [rec["link"]["d2h_bytes"] for rec in per_rank]
            log(f"{label}: {verdict}; losses {[round(x, 5) for x in per_rank[0]['losses']]}; "
                f"launches per rank {[{k: v for k, v in rec['launches'].items() if v} for rec in per_rank]} "
                f"(emulated, all devices in one launch: "
                f"{ {k: v for k, v in emu['launches'].items() if v} }); last launches "
                f"== plain per rank, max_abs_err {[rec['hold_max_abs_err'] for rec in per_rank]}; "
                + (f"wire bytes/step per rank {per_rank[0]['wire']} == emulated"
                   if per_rank[0]["wire"] is not None else "wire not metered (drive takes no meter)")
                + f"; staged D2H "
                f"bytes per rank {staged}; /dev/nvidia* fds per rank "
                f"{[rec['nvidia_fds'] for rec in per_rank]} | {card}")
            report[label] = {"verdict": verdict, "losses": per_rank[0]["losses"],
                             "launches": [rec["launches"] for rec in per_rank],
                             "hold": [rec["hold_max_abs_err"] for rec in per_rank],
                             "wire": per_rank[0]["wire"], "staged": staged, "wall_s": wall}
            del emu
            torch.cuda.empty_cache()
    return report


def run_mesh(shape, backend, cases, params, batches) -> list:
    from repro_torch.launch.mesh import spawn_ranks

    return spawn_ranks(_mesh_rank, shape, _mesh_axes(shape), backend=backend,
                       device="cuda", args=(cases, params, batches))


def phase_mesh(dev, card, overlap_report) -> tuple[int, float, dict]:
    """[mesh]: full-width qwen2-0.5b, 4 gloo ranks on the one card,
    [overlap]'s p = 4 momentum-SGD run without overlap (its batches, its
    seed-0 init), int8 then f32, 3 steps each; the losses held against
    that run's within rtol 1e-6."""
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=512, batch_size=8))
    batches = [pipe.batch_at(0, i) for i in range(MESH_STEPS)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_mesh((4,), "gloo", MESH_FULL, None, batches)
    wall = time.perf_counter() - t0
    spec = grad_spec(build_model(_run_cfg()))
    report, launches, err = {"wall_s": wall}, 0, 0.0
    log(f"[mesh] 4 gloo ranks, full-width qwen2-0.5b at {RUN_DEPTH} of 24 layers "
        f"({spec.size} packed values), "
        f"2 runs x {MESH_STEPS} steps in {wall:.1f} s (spawn, start-up, init, runs) | {card}")
    for i, case in enumerate(MESH_FULL):
        tag = case.get("wire") or "f32"
        label = f"p=4 mpi_sgd sgd {tag}"
        per_rank = [r[i] for r in ranks]
        want_losses = overlap_report[f"driver p=4 {tag} overlap"]["monolithic"]["losses"][:MESH_STEPS]
        _, _, sync = _mesh_case(case)
        legs, _ = _wire_per_step(spec, sync, 4)
        for r, rec in enumerate(per_rank):
            _check_launches(f"{label} rank {r}", rec["launches"],
                            {"sgd_momentum_flat": MESH_STEPS}, MESH_STEPS)
            if rec["hold_shapes"] != {"sgd_momentum_flat": (MESH_SHARD,)}:
                raise AssertionError(f"{label} rank {r}: kernel operands {rec['hold_shapes']}")
            if rec["wire"] != [legs] * MESH_STEPS:
                raise AssertionError(f"{label} rank {r}: wire {rec['wire']} != {legs}")
            if rec["nvidia_fds"] < 1:
                raise AssertionError(f"{label} rank {r}: no /dev/nvidia* open")
            if not rec["losses"][-1] < rec["losses"][0]:
                raise AssertionError(f"{label}: loss did not fall {rec['losses']}")
            rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], want_losses)]
            if max(rel) > 1e-6:
                raise AssertionError(f"{label} rank {r}: losses {rec['losses']} vs "
                                     f"[overlap]'s {want_losses}: rel {rel}")
            launches += rec["launches"]["sgd_momentum_flat"]
            err = max(err, rec["hold_max_abs_err"]["sgd_momentum_flat"])
        rel = max(abs(a - b) / abs(b) for a, b in zip(per_rank[0]["losses"], want_losses))
        log(f"[mesh] {label}: losses {per_rank[0]['losses']} (every rank the same; "
            f"[overlap]'s emulated run {want_losses}, max rel {rel:.3e} <= 1e-6); "
            f"sgd_momentum_flat {[rec['launches']['sgd_momentum_flat'] for rec in per_rank]} "
            f"launches per rank on the ({MESH_SHARD},) f32 shard, the last held == plain within "
            f"phase 2's tolerances (max_abs_err {[rec['hold_max_abs_err']['sgd_momentum_flat'] for rec in per_rank]}); "
            f"wire bytes/step per rank {per_rank[0]['wire'][0]} == cost model | {card}")
        for r, rec in enumerate(per_rank):
            sp = rec["split"]
            mean = lambda k: sum(s.get(k, 0.0) for s in sp[1:]) / max(1, len(sp) - 1)
            log(f"[mesh] {label} rank {r}: step_ms {[round(x, 1) for x in rec['step_ms']]}; "
                f"steps 1-{MESH_STEPS - 1} mean split: grad fn {mean('grad_fn'):.1f} ms, "
                f"reduce-scatter {mean('reduce_scatter'):.1f} ms (D2H "
                f"{mean('reduce_scatter.d2h_ms'):.1f}, send/recv {mean('reduce_scatter.p2p_ms'):.1f}, "
                f"H2D {mean('reduce_scatter.h2d_ms'):.1f}), kernel {mean('kernel'):.3f} ms, "
                f"allgather {mean('allgather'):.1f} ms (D2H {mean('allgather.d2h_ms'):.1f}, "
                f"send/recv {mean('allgather.p2p_ms'):.1f}, H2D {mean('allgather.h2d_ms'):.1f}); "
                f"staged D2H {rec['link']['d2h_bytes']} B / H2D {rec['link']['h2d_bytes']} B "
                f"in {MESH_STEPS} steps; peak {rec['peak_mem_bytes'] / 2**30:.2f} GiB; "
                f"card used {rec['card_used_mib']:.0f} MiB; /dev/nvidia* fds "
                f"{rec['nvidia_fds']} | {card}")
        report[label] = {k: [rec[k] for rec in per_rank] for k in (
            "losses", "step_ms", "split", "link", "peak_mem_bytes", "card_used_mib",
            "launches", "hold_max_abs_err", "wire", "nvidia_fds")}
        report[label]["want_losses"] = want_losses
    return launches, err, report

# ---------------------------------------------------------------------------
# phase 15: the GSPMD path — DTensor state over a process mesh
# ---------------------------------------------------------------------------

GSPMD_STEPS = 3
#: [gspmd:small]: the reduced model, each layout on a mesh over one of
#: [gspmd:families] a)'s 4-rank worlds; AdamW / AdaGrad with a larger eps (1e-3 /
#: 1e-2) than their defaults, which would turn the reduction-order noise
#: of a tiny gradient into a visible step (ROADMAP's parity traps)
GSPMD_SMALL = {
    (2, 2): [dict(opt="sgd"), dict(opt="adamw"), dict(opt="adagrad"),
             dict(opt="sgd", fsdp=True), dict(opt="sgd", seq_shard=True)],
    (2, 1, 2): [dict(opt="sgd", mode="mpi_esgd", clients=2)],
}
GSPMD_HYPER = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=1e-3, eps=1e-3),
               "adagrad": dict(lr=1e-2, eps=1e-2)}
#: [gspmd]: full width, (data 2, model 2), momentum SGD, 4 x 512 tokens;
#: 8 of the 24 layers (cut from the whole depth to pay for phase 15's
#: [gspmd:families] c))
GSPMD_FULL = dict(opt="sgd", full=True, depth=8)
GSPMD_FULL_BATCH = 4
#: [multidevice]: the example's steps (its default 12 cut to keep the smoke
#: in its time; the exchange at step 0)
MULTIDEVICE_STEPS = 4


def _gspmd_axes(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _gspmd_label(shape, case) -> str:
    extra = "".join(f" {k}" + (f"={v}" if v is not True else "")
                    for k, v in case.items() if k in ("fsdp", "seq_shard", "microbatch"))
    return (f"({', '.join(f'{a} {n}' for a, n in zip(_gspmd_axes(shape), shape))}) "
            f"{case.get('mode', 'mpi_sgd')} {case['opt']}{extra}"
            + (f" C={case['clients']}" if case.get("clients") else ""))


def _gspmd_case(case):
    """A case's model, optimizer, per-leaf SyncConfig and batches (a C > 1
    batch stacked (C, B / C, S), one pipeline shard a client)."""
    cfg = get_config("qwen2-0.5b")
    cfg = dataclasses.replace(cfg if case.get("full") else reduced(cfg),
                              seq_shard_activations=case.get("seq_shard", False))
    if case.get("depth"):
        cfg = dataclasses.replace(cfg, num_layers=case["depth"])
    model = build_model(cfg)
    opt = sgd_mod.get_optimizer(case["opt"], **GSPMD_HYPER[case["opt"]])
    C = case.get("clients", 1)
    sync = SyncConfig(mode=case.get("mode", "mpi_sgd"), num_clients=C,
                      esgd_alpha=0.5, esgd_interval=2, fsdp=case.get("fsdp", False),
                      fused_update=False, flat_exchange=False)
    B, S = (GSPMD_FULL_BATCH, 512) if case.get("full") else (8, 32)
    batches = []
    for i in range(GSPMD_STEPS):
        parts = [TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=S,
                                          batch_size=B // C, shard=c)).batch_at(0, i)
                 for c in range(C)]
        batches.append(parts[0] if C == 1 else
                       {k: torch.stack([p[k] for p in parts]) for k in parts[0]})
    return model, opt, sync, batches


def _gspmd_run(mesh, case) -> dict:
    """``GSPMD_STEPS`` steps of ``case`` from the seed-0 init: on the
    DTensor state of ``mesh`` (through ``make_train_state(mesh=)`` and
    ``make_train_step(mesh)``), or in one process with ``mesh=None`` — the
    per-leaf step it is held to. The kernels' launch counts are set to 0
    just before the steps and read just after."""
    model, opt, sync, batches = _gspmd_case(case)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, opt, sync, 0, mesh=mesh)
    split = {} if mesh is not None else None
    step = make_train_step(model, opt, sync, mesh, split=split,
                           microbatch=case.get("microbatch", 1))
    rec = {"losses": [], "step_ms": [], "split": [], "staged": [], "staged_by_op": []}
    if mesh is not None:
        mesh.link.stats.reset()
    reset_counts()
    for b in batches:
        before = (mesh.link.stats.d2h_bytes + mesh.link.stats.h2d_bytes
                  if mesh is not None else 0)
        by_op = _fam_staged(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(float(met["loss"]))
        if mesh is not None:
            rec["split"].append({k: v * 1e3 for k, v in split.items()})
            split.clear()
            rec["staged"].append(mesh.link.stats.d2h_bytes + mesh.link.stats.h2d_bytes
                                 - before)
            rec["staged_by_op"].append(_fam_delta(by_op, _fam_staged(mesh)))
    rec["launches"] = counts(ALL_KERNELS)
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if mesh is not None:
        torch.distributed.barrier()             # every rank holds its state
        free, total = torch.cuda.mem_get_info()
        rec["card_used_mib"] = (total - free) / 2**20
        torch.distributed.barrier()
        rec["nvidia_fds"] = _nvidia_fds()
    if not case.get("full"):
        with (mesh.dtensor_collectives() if mesh is not None
              else contextlib.nullcontext()):
            full = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t,
                            state)
        rec["state"] = tree_map(lambda t: t.cpu(), full)
    del state, step
    torch.cuda.empty_cache()
    return rec


def _gspmd_check_zero_launches(label, recs) -> None:
    for r, rec in enumerate(recs):
        if any(rec["launches"].values()):
            raise AssertionError(f"{label} rank {r}: the GSPMD path launched "
                                 f"{rec['launches']}")


def _gspmd_hold_state(label, got, want) -> float:
    """Every leaf within rtol 1e-5 of its value and of the leaf's scale;
    -> the worst deviation over the leaf's scale."""
    worst = 0.0
    for key in want:
        for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            a, b = a.float(), b.float()
            scale = float(b.abs().max()) if b.numel() else 0.0
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale):
                raise AssertionError(f"{label}: {key} leaf {tuple(b.shape)} off by "
                                     f"{float((a - b).abs().max())} (scale {scale})")
            if scale:
                worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def phase_gspmd_small(card, ranks) -> dict:
    """[gspmd:small]: the reduced model's GSPMD step as gloo ranks on the
    card, each case held against the one-process per-leaf step on the
    card: losses and the gathered final state within rtol 1e-5.
    ``ranks``: layout -> each rank's records, in case order, from the 4-rank
    worlds of [gspmd:families] a) (``phase_gspmd_families_small``), each
    layout on its own mesh over one of them."""
    report = {}
    for shape, cases in GSPMD_SMALL.items():
        for i, case in enumerate(cases):
            label = f"[gspmd:small] {_gspmd_label(shape, case)}"
            per_rank = [r[i] for r in ranks[shape]]
            want = _gspmd_run(None, case)
            _gspmd_check_zero_launches(label, per_rank + [want])
            worst, rel = 0.0, 0.0
            for r, rec in enumerate(per_rank):
                rel = max(rel, max(abs(a - b) / abs(b)
                                   for a, b in zip(rec["losses"], want["losses"])))
                if rel > 1e-5:
                    raise AssertionError(f"{label} rank {r}: losses {rec['losses']} vs "
                                         f"one process {want['losses']}")
                worst = max(worst, _gspmd_hold_state(f"{label} rank {r}", rec["state"],
                                                     want["state"]))
            log(f"{label}: losses {per_rank[0]['losses']} (one process "
                f"{want['losses']}, max rel {rel:.2e} <= 1e-5); gathered state within "
                f"rtol 1e-5 (worst {worst:.2e} of a leaf's scale); the 14 kernels "
                f"launched 0 times in every rank; staged a rank a step "
                f"{per_rank[0]['staged']} B | {card}")
            report[label] = {"losses": per_rank[0]["losses"], "want": want["losses"],
                             "loss_rel": rel, "state_worst": worst,
                             "staged": [rec["staged"] for rec in per_rank]}
    return report


def phase_gspmd(card, per_rank) -> dict:
    """[gspmd]: full-width qwen2-0.5b as 4 gloo ranks (data 2, model 2) on
    the card, 3 momentum-SGD steps, against the one-process per-leaf step
    on the same batches (losses within rtol 1e-4). ``per_rank``: each
    rank's record from the spawn it shares with [gspmd:families] b) and c)
    (``spawn_full_width``), where it ran first."""
    torch.cuda.empty_cache()
    wall = per_rank[0]["wall_s"]
    want = _gspmd_run(None, GSPMD_FULL)
    label = (f"[gspmd] (data 2, model 2) mpi_sgd sgd, full-width qwen2-0.5b at "
             f"{GSPMD_FULL['depth']} of 24 layers")
    _gspmd_check_zero_launches(label, per_rank + [want])
    rel = 0.0
    for r, rec in enumerate(per_rank):
        rel = max(rel, max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], want["losses"])))
        if rel > 1e-4:
            raise AssertionError(f"{label} rank {r}: losses {rec['losses']} vs one "
                                 f"process {want['losses']}")
        if not rec["losses"][-1] < rec["losses"][0]:
            raise AssertionError(f"{label}: loss did not fall {rec['losses']}")
    log(f"{label}: 4 ranks, {GSPMD_STEPS} steps of {GSPMD_FULL_BATCH} x 512 in "
        f"{wall:.1f} s (mesh, init, runs; spawned with b) and c)); losses "
        f"{per_rank[0]['losses']} "
        f"(one process {want['losses']}, max rel {rel:.2e} <= 1e-4); the 14 kernels "
        f"launched 0 times in every rank; one-process step_ms "
        f"{[round(x, 1) for x in want['step_ms']]}, peak "
        f"{want['peak_mem_bytes'] / 2**30:.2f} GiB | {card}")
    for r, rec in enumerate(per_rank):
        sp = rec["split"][1:] or rec["split"]
        mean = lambda k: sum(s.get(k, 0.0) for s in sp) / len(sp)
        log(f"[gspmd] rank {r}: step_ms {[round(x, 1) for x in rec['step_ms']]}; steps "
            f"1-{GSPMD_STEPS - 1} mean split: forward + backward (with the tensor-parallel "
            f"collectives) {mean('fwd_bwd'):.1f} ms, gradient redistribute "
            f"{mean('grad_sync'):.1f} ms, update {mean('update'):.1f} ms; staged a step "
            f"{rec['staged']} B; peak {rec['peak_mem_bytes'] / 2**30:.2f} GiB; card used "
            f"{rec['card_used_mib']:.0f} MiB | {card}")
    return {"wall_s": wall, "want": {k: want[k] for k in ("losses", "step_ms", "peak_mem_bytes")},
            "ranks": [{k: rec[k] for k in ("losses", "step_ms", "split", "staged",
                                           "peak_mem_bytes", "card_used_mib", "launches")}
                      for rec in per_rank]}


def phase_multidevice(card) -> dict:
    """``python -m repro_torch.launch.multidevice_train --steps
    MULTIDEVICE_STEPS`` on the card: 8 gloo ranks (pod 2, data 2, model 2),
    the reduced model, mpi-ESGD with C = 2; the loss falls and the
    consensus line is printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.multidevice_train",
                           "--steps", str(MULTIDEVICE_STEPS)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[multidevice] exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    losses = [float(m.group(1)) for m in
              (re.match(r"step\s+\d+ loss (\S+) replica spread", ln) for ln in lines) if m]
    if len(losses) != MULTIDEVICE_STEPS or not losses[-1] < losses[0]:
        raise AssertionError(f"[multidevice] losses {losses}")
    if not lines[-1].startswith("consensus model:"):
        raise AssertionError(f"[multidevice] last line {lines[-1]!r}")
    for ln in lines:
        log(f"[multidevice] {ln}")
    log(f"[multidevice] 8 gloo ranks on the card in {wall:.1f} s (spawn, start-up, "
        f"{MULTIDEVICE_STEPS} steps); loss {losses[0]:.4f} -> {losses[-1]:.4f} | {card}")
    return {"wall_s": wall, "losses": losses, "last": lines[-1]}


# ---------------------------------------------------------------------------
# phase 15 d: the MoE, SSM and hybrid families and the decode step on the mesh
# ---------------------------------------------------------------------------

#: [gspmd:families] a): the CPU tests' cases, run by their rank workers
#: (tests/_torch_gspmd_families.py, which imports no JAX) on the card
FAM_RTOL = 1e-5
#: a)'s decode on the card: a 4-token prompt, then 4 greedy tokens (the
#: CPU tests' 16 + 8 cut to keep the smoke in its time; the greedy tokens
#: write cache slots 4-7 of 24, so slots 6 and 7 lie past a 4-way sequence
#: shard's boundary — 4 + 2 would not reach it)
FAM_SMALL_DECODE = (4, 4)
#: zamba2's state after steps 1 and 3, as a share of a leaf's scale: its
#: gradients amplify noise — a 1e-7 relative change of the initial params
#: moves the state by 1.4e-5 after one step and 3.4e-4 after three (CPU),
#: so no other summation order meets 1e-5 there. On the card the mesh came
#: 1.04e-5 / 1.8e-5 (two runs) and 2.2e-3 from one process.
FAM_STATE_BAND = {"zamba2-1.2b": (1e-4, 1e-2)}
#: [gspmd:families] b): full width, depth cut where a full depth does not
#: fit the budget. mixtral trains only reduced (a): a full-width step would
#: cost more of the card budget than its 2-layer cut pays for. mamba2 and
#: zamba2 run in f32: in bf16 their losses drift apart by the third step
#: (1.4e-3 and 4.9e-3 of the loss on the card), the SSM drift ROADMAP's
#: parity traps record for their decode. A decode step on the mesh costs
#: 0.2–3 s (4 processes time-slice one card, ~10 staged collectives a
#: layer), so each case decodes 2 + 2 tokens, qwen2-0.5b 4 + 4 (cut from
#: 4 + 4 and 8 + 8 to pay for c)); mamba2 and qwen2-0.5b run 8 of their 24
#: layers (cut from the whole depth for the same).
FAM_MOE_AXES, FAM_DENSE_AXES = ("data", "expert", "tp"), ("data", "model")
GSPMD_FAMILIES_FULL = (
    dict(name="qwen2-moe-a2.7b", depth=2, mesh=(2, 2, 1), axes=FAM_MOE_AXES,
         train=(4, 512), batch=4, prompt=2, new=2, dtype="bfloat16"),
    dict(name="mixtral-8x7b", depth=2, mesh=(1, 2, 2), axes=FAM_MOE_AXES,
         train=None, batch=4, prompt=2, new=2, dtype="bfloat16"),
    dict(name="mamba2-130m", depth=8, mesh=(2, 2), axes=FAM_DENSE_AXES,
         train=(4, 512), batch=4, prompt=2, new=2, dtype="float32"),
    dict(name="zamba2-1.2b", depth=6, mesh=(2, 2), axes=FAM_DENSE_AXES,
         train=(2, 512), batch=4, prompt=2, new=2, dtype="float32"),
    dict(name="qwen2-0.5b", depth=8, mesh=(1, 4), axes=FAM_DENSE_AXES,
         train=None, batch=4, prompt=4, new=4, dtype="bfloat16"),
)
#: [gspmd:families] c): the encoder-decoder, the VLM and the dense
#: decoders with biases, qk-norm and 40 / 10 heads at full width in bf16,
#: in the same spawn as b), each on its own layout of the world. whisper
#: at full depth (6 + 6) and paligemma at 2 of 18 layers train 3 steps
#: (4 x 448 tokens with 1500 frames; 4 x (256 image + 256 text)); the
#: dense trio at 2 layers (of 36, 36, 40) only prefills and decodes.
#: Each prefills its (batch, sequence) and decodes B 4, 4 + 4 tokens;
#: whisper's cache holds a nonzero encoder output set by hand
#: (``init_cache`` makes zeros, as the reference's).
GSPMD_FAMILIES_C = (
    dict(name="whisper-base", depth=6, mesh=(2, 2), axes=FAM_DENSE_AXES,
         train=(4, 448), prefill=(4, 448), batch=4, prompt=4, new=4, dtype="bfloat16"),
    dict(name="paligemma-3b", depth=2, mesh=(2, 2), axes=FAM_DENSE_AXES,
         train=(4, 512), prefill=(4, 512), batch=4, prompt=4, new=4, dtype="bfloat16"),
    dict(name="qwen2.5-3b", depth=2, mesh=(2, 2), axes=FAM_DENSE_AXES,
         train=None, prefill=(4, 512), batch=4, prompt=4, new=4, dtype="bfloat16"),
    dict(name="qwen3-4b", depth=2, mesh=(2, 2), axes=FAM_DENSE_AXES,
         train=None, prefill=(4, 512), batch=4, prompt=4, new=4, dtype="bfloat16"),
    dict(name="phi3-medium-14b", depth=2, mesh=(1, 4), axes=FAM_DENSE_AXES,
         train=None, prefill=(4, 512), batch=4, prompt=4, new=4, dtype="bfloat16"),
)
#: a c) prefill's logits against one process, over the last positions
#: only (the whole (4, 512, 257,216) bf16 block of paligemma is 1 GB a
#: rank to gather): within the serve phases' 4 % bf16 band of max |logit|
FAM_PREFILL_TAIL, FAM_PREFILL_BAND = 8, 0.04
#: training losses on the mesh against the one-process step
FAM_FULL_LOSS_RTOL = 1e-3


def _fam_harness():
    path = str(ROOT / "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import _torch_gspmd_families as GF
    return GF


def _fam_small_paths(GF, seconds: dict | None = None) -> dict:
    """The harness's paths with a) 's shorter decode (``FAM_SMALL_DECODE``);
    each job's wall seconds go into ``seconds`` when it is given."""
    prompt, new = FAM_SMALL_DECODE
    paths = dict(GF.PATHS, decode=lambda mesh, case, device: GF.decode(
        mesh, case, device, prompt=prompt, new=new))
    if seconds is None:
        return paths

    def timed(path, fn):
        def run(mesh, case, device):
            t0 = time.perf_counter()
            out = fn(mesh, case, device)
            seconds[f"{path} {case}"] = round(time.perf_counter() - t0, 2)
            return out
        return run
    return {path: timed(path, fn) for path, fn in paths.items()}


def _fam_small_rank(world, jobs, gspmd_jobs=()) -> dict:
    """One rank of a [gspmd:families] a) world: its jobs, each on its
    case's own layout of the world (``world_rank``), the 14 kernels'
    launches (their counts set to 0 just before), the bytes staged by
    collective over all its layouts and each job's wall seconds; then the
    [gspmd:small] ``(shape, case)`` jobs, each shape on a mesh of its own
    over the world (one process start for both)."""
    from repro_torch.launch.mesh import _mesh_over_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    GF = _fam_harness()
    reset_counts()
    meshes, seconds = {}, {}
    out = GF.world_rank(world, jobs, device="cuda", meshes=meshes,
                        paths=_fam_small_paths(GF, seconds))
    launches = counts(ALL_KERNELS)
    staged = {}
    for mesh in meshes.values():
        for k, v in mesh.link.stats.by_op.items():
            staged[k] = staged.get(k, 0) + v
    gspmd, gmeshes = [], {}
    for shape, case in gspmd_jobs:
        t0 = time.perf_counter()
        if shape not in gmeshes:
            gmeshes[shape] = _mesh_over_world(shape, _gspmd_axes(shape), world.device,
                                              "[gspmd:small]")
        gspmd.append(_gspmd_run(gmeshes[shape], case))
        seconds[f"[gspmd:small] {_gspmd_label(shape, case)}"] = round(
            time.perf_counter() - t0, 2)
    return {"jobs": out, "launches": launches, "staged": staged, "seconds": seconds,
            "gspmd": gspmd}


def _fam_close(label, a, b, rtol) -> float:
    """``a`` within ``rtol`` of ``b`` and of b's scale (max |b|); -> the
    deviation over the scale."""
    a, b = a.float(), b.float()
    if a.shape != b.shape:
        raise AssertionError(f"{label}: shape {tuple(a.shape)} != {tuple(b.shape)}")
    scale = float(b.abs().max()) if b.numel() else 0.0
    diff = float((a - b).abs().max()) if b.numel() else 0.0
    if not torch.allclose(a, b, rtol=rtol, atol=rtol * scale):
        raise AssertionError(f"{label}: off by {diff} (scale {scale}, rtol {rtol})")
    return diff / scale if scale else 0.0


def _fam_close_trees(label, got, want, rtol) -> float:
    gl, wl = tree_leaves(got), tree_leaves(want)
    if len(gl) != len(wl):
        raise AssertionError(f"{label}: {len(gl)} leaves != {len(wl)}")
    return max([_fam_close(label, a, b, rtol) for a, b in zip(gl, wl)] or [0.0])


def _fam_hold(GF, label, path, case, got, want) -> str:
    """One rank's ``path`` run of ``case`` against the one-process run at
    the CPU tests' tolerances; -> what was held."""
    if path == "train":
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        if rel > FAM_RTOL:
            raise AssertionError(f"{label}: losses {got['losses']} vs {want['losses']}")
        for gm, wm in zip(got["metrics"], want["metrics"]):
            for k in wm:
                if abs(gm[k] - wm[k]) > FAM_RTOL * abs(wm[k]):
                    raise AssertionError(f"{label}: metric {k} {gm[k]} vs {wm[k]}")
        b1, b3 = FAM_STATE_BAND.get(case, (FAM_RTOL, FAM_RTOL))
        first = _fam_close_trees(label + " first-step state", got["first"], want["first"],
                                 b1)
        last = _fam_close_trees(label + " final state", got["state"], want["state"], b3)
        return (f"losses {[round(x, 6) for x in got['losses']]} (max rel {rel:.1e}); "
                f"state after step 1 worst {first:.1e} (<= {b1}), after step "
                f"{len(want['losses'])} worst {last:.1e} (<= {b3}) of a leaf's scale")
    if path == "prefill":
        worst = _fam_close(label, got["logits"], want["logits"], FAM_RTOL)
        note = f"logits {tuple(want['logits'].shape)} worst {worst:.1e} of their scale"
        if want["dispatch"]:
            half = GF.BATCH // 2
            rows = slice(got["row0"], got["row0"] + half)
            for (e, cap, slot, keep), (we, wcap, wslot, wkeep) in zip(
                    got["dispatch"], want["dispatch"]):
                if not (cap == wcap and torch.equal(e, we[rows]) and torch.equal(
                        slot, wslot[rows]) and torch.equal(keep, wkeep[rows])):
                    raise AssertionError(f"{label}: dispatch of rows {rows} differs")
            note += (f"; dispatch slots / keeps of its rows == one process in all "
                     f"{len(want['dispatch'])} layers")
        return note
    worst = max(_fam_close(f"{label} step {t}", got["logits"][t], want["logits"][t],
                           FAM_RTOL) for t in range(want["logits"].shape[0]))
    if not torch.equal(got["tokens"], want["tokens"]):
        raise AssertionError(f"{label}: greedy {got['tokens']} vs {want['tokens']}")
    cache = _fam_close_trees(label + " cache", got["cache"], want["cache"], FAM_RTOL)
    return (f"{want['logits'].shape[0]} steps' logits worst {worst:.1e}, greedy tokens "
            f"equal, cache worst {cache:.1e} of a leaf's scale")


def _fam_mesh_label(shape, axes) -> str:
    return "(" + ", ".join(f"{a} {n}" for a, n in zip(axes, shape)) + ")"


def phase_gspmd_families_small(card) -> tuple[dict, dict]:
    """[gspmd:families] a): the CPU tests' reduced cases (f32) as gloo
    ranks sharing the card, in three worlds spawned side by side, each
    case on its own layout (``GF.CASES``) — 8 ranks for the MoE on (data
    2, expert 2, tp 2); 4 for mamba2 / zamba2 and qwen2-0.5b's KV-head
    cache on (data 2, model 2) and its sequence-sharded cache on (data 1,
    model 4); 4 for whisper, paligemma, qwen2.5-3b, qwen3-4b and phi3 on
    (2, 2) and qwen2.5-3b on (1, 4) — each held against the one-process
    run on the card. The two 4-rank worlds then run [gspmd:small]'s
    layouts, (2, 2) and (2, 1, 2): fewer processes for the host's 8 cores.
    -> (a)'s report, [gspmd:small]'s records by layout)."""
    from repro_torch.launch.mesh import spawn_ranks

    GF = _fam_harness()
    paths = ("train", "prefill", "decode")
    moe = [(p, c) for c, m in GF.MESHES.items() if m[1] == GF.MOE_AXES for p in paths]
    ssm_qwen2 = ([(p, c) for c, m in GF.MESHES.items() if m[1] != GF.MOE_AXES for p in paths]
                 + [("decode", c) for c in GF.DECODE if c not in GF.MESHES])
    encdec_vlm_dense = [(p, c) for c in {**GF.ENCDEC_VLM, **GF.DENSE} for p in paths]
    # three worlds side by side: the MoE's 8 ranks, and two of 4 that split
    # the (data, model) cases so neither holds up the others
    worlds = [(8, moe), (4, ssm_qwen2), (4, encdec_vlm_dense)]
    small = {1: (2, 2), 2: (2, 1, 2)}       # world -> its [gspmd:small] layout
    gspmd_jobs = [[(small[w], c) for c in GSPMD_SMALL[small[w]]] if w in small else []
                  for w in range(len(worlds))]
    if sorted(small.values()) != sorted(GSPMD_SMALL):
        raise AssertionError(f"[gspmd:small] layouts {list(GSPMD_SMALL)} vs {small}")
    one_process = _fam_small_paths(GF)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(worlds)) as ex:
        futs = [ex.submit(spawn_ranks, _fam_small_rank, (n,), ("world",),
                          backend="gloo", device="cuda", args=(jobs, gj))
                for (n, jobs), gj in zip(worlds, gspmd_jobs)]
        # meanwhile, the one-process runs on the card, once an arch
        by_arch = {}
        for _, jobs in worlds:
            for path, case in jobs:
                key = (path, GF.arch_of(case))
                if key in by_arch:
                    continue
                reset_counts()
                by_arch[key] = one_process[path](None, case, "cuda")
                if any(counts(ALL_KERNELS).values()):
                    raise AssertionError(f"[gspmd:families] one-process {path} {case} "
                                         f"launched {counts(ALL_KERNELS)}")
        wants = {(path, case): by_arch[(path, GF.arch_of(case))]
                 for _, jobs in worlds for path, case in jobs}
        ranks = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    n = sum(w for w, _ in worlds)
    log(f"[gspmd:families] a) {n} gloo ranks on the card in {len(worlds)} worlds, "
        f"spawned side by side, the one-process runs meanwhile: "
        f"{sum(len(j) for _, j in worlds)} runs and [gspmd:small]'s "
        f"{sum(map(len, gspmd_jobs))} in {wall:.1f} s | {card}")
    report = {"wall_s": wall}
    gspmd = {small[w]: [rec["gspmd"] for rec in ranks[w]] for w in small}
    for (size, jobs), per_rank in zip(worlds, ranks):
        for r, rec in enumerate(per_rank):
            if any(rec["launches"].values()):
                raise AssertionError(f"[gspmd:families] a) world of {size} rank {r} "
                                     f"launched {rec['launches']}")
        for path, case in jobs:
            want = wants[(path, case)]
            ml = _fam_mesh_label(*GF.CASES[case][1])
            label = f"[gspmd:families] a) {path} {case} {ml}"
            notes = [_fam_hold(GF, f"{label} rank {r}", path, case, rec["jobs"][(path, case)],
                               want) for r, rec in enumerate(per_rank)]
            log(f"{label}: every rank == one process on the card: {notes[0]}")
            report[label] = notes[0]
        cases = sorted({c for _, c in jobs})
        log(f"[gspmd:families] a) world of {size} ({', '.join(cases)}): the 14 kernels "
            f"launched 0 times in every rank; rank 0 staged {per_rank[0]['staged']} B by "
            f"collective over its {len(jobs)} runs; rank 0's seconds a run "
            f"{per_rank[0]['seconds']} | {card}")
        report[f"staged world of {size}: {', '.join(cases)}"] = per_rank[0]["staged"]
    return report, gspmd


def _fam_full_cfg(case: dict):
    return dataclasses.replace(get_config(case["name"]), num_layers=case["depth"],
                               dtype=case["dtype"])


def _fam_staged(mesh) -> dict:
    return dict(mesh.link.stats.by_op) if mesh is not None else {}


def _fam_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _fam_full_run(mesh, case) -> dict:
    """A full-width case, on ``mesh`` (a rank) or in one process: the
    training steps (timed, split, bytes staged by collective, the MoE's
    routes of the first step's forward), the prefill (timed, its staged
    bytes, the last positions' logits), then the decode (every step
    timed, its staged bytes, its logits on rank 0 / one process, the
    greedy tokens). Batches carry every ``input_specs`` key (the stub
    audio frames / image embeddings, ``batches_for``). The 14 kernels'
    counts are set to 0 first."""
    GF = _fam_harness()
    name, depth, train = case["name"], case["depth"], case["train"]
    B, P, new = case["batch"], case["prompt"], case["new"]
    cfg = _fam_full_cfg(case)
    model = build_model(cfg)
    rec = {"index": mesh.index if mesh is not None else 0}
    reset_counts()
    if train:
        Bt, S = train
        opt = sgd_optimizer(0.1, momentum=0.9)
        sync = SyncConfig(fused_update=False, flat_exchange=False)
        batches = GF.batches_for(model, Bt, S, GSPMD_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(model, opt, sync, 0, mesh=mesh)
        split = {} if mesh is not None else None
        step = make_train_step(model, opt, sync, mesh, split=split)
        routes, orig = [], moe_mod._dispatch_indices

        def recording(e, E, C):
            if len(routes) < depth:         # the first step's forward
                routes.append(e.cpu())
            return orig(e, E, C)

        t_rec = {"losses": [], "step_ms": [], "split": [], "staged": []}
        moe_mod._dispatch_indices = recording
        try:
            for b in batches:
                before = _fam_staged(mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, b)
                torch.cuda.synchronize()
                t_rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                t_rec["losses"].append(float(met["loss"]))
                t_rec["staged"].append(_fam_delta(before, _fam_staged(mesh)))
                if split is not None:
                    t_rec["split"].append({k: v * 1e3 for k, v in split.items()})
                    split.clear()
        finally:
            moe_mod._dispatch_indices = orig
        t_rec["routes"] = routes
        t_rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if mesh is not None:
            torch.distributed.barrier()             # every rank holds its state
            free, total = torch.cuda.mem_get_info()
            t_rec["card_used_mib"] = (total - free) / 2**20
            torch.distributed.barrier()
        rec["train"] = t_rec
        del state, step
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(device="cuda", seed=0)
    if mesh is not None:
        with mesh.dtensor_collectives():
            params = distribute(params, param_specs(params, mesh), mesh)
    if case.get("prefill"):
        rec["prefill"] = _fam_full_prefill(GF, mesh, model, params, case)
    cache = model.init_cache(B, P + new, "cuda")
    if "enc" in cache:
        cache["enc"].copy_(GF.enc_output(model, B))
    step = make_serve_step(model, mesh)
    prompts = TokenPipeline(DataConfig(seed=1, vocab_size=256, seq_len=P,
                                       batch_size=B)).batch_at(0, 0)["tokens"].cuda()
    d_rec = {"step_ms": [], "staged": [], "tokens": []}
    logits, tok = [], None
    with torch.no_grad():
        for t in range(P + new):
            inp = prompts[:, t:t + 1] if t < P else tok
            before = _fam_staged(mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step(params, cache, inp)
            torch.cuda.synchronize()
            d_rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            d_rec["staged"].append(_fam_delta(before, _fam_staged(mesh)))
            last = lg[:, -1, :cfg.vocab_size].float()
            if not bool(torch.isfinite(last).all()):
                raise AssertionError(f"{name} decode step {t}: non-finite logits")
            if rec["index"] == 0:
                logits.append(last.cpu())
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            if t >= P - 1 and len(d_rec["tokens"]) < new:
                d_rec["tokens"].append(tok.cpu())
    d_rec["tokens"] = torch.cat(d_rec["tokens"], dim=1)
    d_rec["logits"] = torch.stack(logits) if logits else None
    d_rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if mesh is not None:
        torch.distributed.barrier()
        free, total = torch.cuda.mem_get_info()
        d_rec["card_used_mib"] = (total - free) / 2**20
        torch.distributed.barrier()
    rec["decode"] = d_rec
    rec["launches"] = counts(ALL_KERNELS)
    del params, cache, step
    torch.cuda.empty_cache()
    return rec


def _fam_full_prefill(GF, mesh, model, params, case) -> dict:
    """``make_prefill_step`` over the first batch of ``case["prefill"]``'s
    shape (its labels left out), twice: the first call warm, the second
    timed with its staged bytes; the last ``FAM_PREFILL_TAIL`` positions'
    logits (whole, on the host) and the logits' shape."""
    from repro_torch.launch.serve import make_prefill_step

    Bp, S = case["prefill"]
    batch = {k: v for k, v in GF.batches_for(model, Bp, S, 1)[0].items() if k != "labels"}
    step = make_prefill_step(model, mesh)
    ctx = mesh.dtensor_collectives() if mesh is not None else contextlib.nullcontext()
    out = {}
    for _ in range(2):
        before = _fam_staged(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["staged"] = _fam_delta(before, _fam_staged(mesh))
        with torch.no_grad(), ctx:
            tail = logits[:, -FAM_PREFILL_TAIL:]
            tail = tail.full_tensor() if mesh is not None else tail
            tail = tail[..., :model.cfg.vocab_size].float().cpu()
        out["shape"] = tuple(logits.shape)
        del logits
    if not bool(torch.isfinite(tail).all()):
        raise AssertionError(f"{case['name']} prefill: non-finite logits")
    out["tail"] = tail
    return out


def _fam_full_rank(world, cases, gspmd_case=None) -> dict:
    """One rank of [gspmd] and [gspmd:families] b) and c) (a spawned
    process, the card shared): ``gspmd_case`` first on (data 2, model 2),
    then every case in turn on its own layout of the same 4-rank world
    (one process start for all of them), each run's wall seconds beside
    its record."""
    from repro_torch.launch.mesh import _mesh_over_world

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"gspmd": None, "families": []}
    if gspmd_case is not None:
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        mesh = _mesh_over_world((2, 2), _gspmd_axes((2, 2)), world.device, "[gspmd]")
        rec = _gspmd_run(mesh, gspmd_case)
        torch.distributed.barrier()
        rec["wall_s"] = time.perf_counter() - t0
        out["gspmd"] = rec
    for case in cases:
        t0 = time.perf_counter()
        mesh = _mesh_over_world(case["mesh"], case["axes"], world.device,
                                "[gspmd:families] b) and c)")
        rec = _fam_full_run(mesh, case)
        torch.distributed.barrier()
        rec["wall_s"] = time.perf_counter() - t0
        out["families"].append(rec)
    return out


def _fam_route_diffs(case, rank_rec, want) -> tuple:
    """(token, k) routes of the first step's forward on a rank against the
    same rows of the one-process run: (differing, total)."""
    shape, Bt = case["mesh"], case["train"][0]
    data = shape[0]                                 # 'data' is the first axis
    coord = rank_rec["index"] // math.prod(shape[1:])
    rows = slice(coord * Bt // data, (coord + 1) * Bt // data)
    diff = total = 0
    for e, we in zip(rank_rec["train"]["routes"], want["train"]["routes"]):
        diff += int((e != we[rows]).sum())
        total += e.numel()
    return diff, total


def spawn_full_width(card) -> list:
    """[gspmd]'s and [gspmd:families] b)'s and c)'s full-width runs in one
    spawn of 4 gloo ranks sharing the card (one process start for all):
    each rank's ``_fam_full_rank`` record."""
    from repro_torch.launch.mesh import spawn_ranks

    cases = GSPMD_FAMILIES_FULL + GSPMD_FAMILIES_C
    n = {math.prod(c["mesh"]) for c in cases}
    if n != {4}:        # [gspmd]'s (data 2, model 2) too
        raise AssertionError(f"[gspmd:families] the full-width cases need {n} ranks")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(_fam_full_rank, (4,), ("world",), backend="gloo",
                        device="cuda", args=(cases, GSPMD_FULL))
    log(f"[gspmd] and [gspmd:families] b) and c): 4 gloo ranks on the card ran the "
        f"{1 + len(cases)} full-width cases in {time.perf_counter() - t0:.1f} s (spawn "
        f"and start-up once) | {card}")
    return ranks


def phase_gspmd_families(card, all_ranks) -> dict:
    """[gspmd:families] b) and c): the full-width cases as 4 gloo ranks
    sharing the card (``spawn_full_width``; each case on its own layout of
    the world), then each in one process on the card from the same seed:
    training losses within rtol 1e-3 (the difference printed; for the MoE
    how many (token, k) routes differ), c)'s prefill logits over the last
    positions within 4 % of max |logit|, greedy decode tokens equal
    wherever the one-process top-2 margin exceeds twice the logit band
    measured over the teacher-forced prompt (``_logit_margins``, the serve
    phases' rule); per rank the step ms and its split, the prefill ms, ms
    a decode token, bytes staged a step, a prefill and a token by
    collective, peak memory and the card's used MiB."""
    cases = GSPMD_FAMILIES_FULL + GSPMD_FAMILIES_C
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    for i, case in enumerate(cases):
        name, depth, shape, axes = case["name"], case["depth"], case["mesh"], case["axes"]
        train, B, P, new = case["train"], case["batch"], case["prompt"], case["new"]
        ml = _fam_mesh_label(shape, axes)
        sub = "c)" if case in GSPMD_FAMILIES_C else "b)"
        label = f"[gspmd:families] {sub} {name} ({depth} layers, {case['dtype']}) {ml}"
        ranks = [r[i] for r in all_ranks]
        wall = ranks[0]["wall_s"]
        torch.cuda.empty_cache()
        want = _fam_full_run(None, case)
        for r, rec in enumerate(ranks + [want]):
            if any(rec["launches"].values()):
                raise AssertionError(f"{label} run {r} launched {rec['launches']}")
        out = {"wall_s": wall, "ranks": []}
        numel = sum(a.numel() for a in tree_leaves(build_model(
            _fam_full_cfg(case)).init(device="meta")))
        log(f"{label}: {math.prod(shape)} ranks, {numel} params, trained and served in "
            f"{wall:.1f} s; the 14 kernels launched 0 times in every rank and in the "
            f"one-process run | {card}")
        if train:
            wl = want["train"]["losses"]
            rel = max(max(abs(a - b) / abs(b) for a, b in zip(rec["train"]["losses"], wl))
                      for rec in ranks)
            if not rel <= FAM_FULL_LOSS_RTOL:
                raise AssertionError(f"{label}: losses {ranks[0]['train']['losses']} vs "
                                     f"one process {wl} (max rel {rel})")
            note = ""
            if want["train"]["routes"]:
                diffs = [_fam_route_diffs(case, rec, want) for rec in ranks]
                note = (f"; (token, k) routes of the first step differing from one "
                        f"process: {[d for d, _ in diffs]} of {[t for _, t in diffs]} "
                        f"a rank")
                out["route_diffs"] = diffs
            log(f"{label} train {GSPMD_STEPS} steps of {train[0]} x {train[1]}: losses "
                f"{ranks[0]['train']['losses']} (one process {wl}, max rel {rel:.2e} <= "
                f"{FAM_FULL_LOSS_RTOL}){note}; one-process step_ms "
                f"{[round(x, 1) for x in want['train']['step_ms']]}, peak "
                f"{want['train']['peak_mem_bytes'] / 2**30:.2f} GiB | {card}")
            out.update(loss_rel=rel, losses=ranks[0]["train"]["losses"], want_losses=wl)
        if case.get("prefill"):
            wp = want["prefill"]
            pscale = float(wp["tail"].abs().max())
            pband = max(float((rec["prefill"]["tail"] - wp["tail"]).abs().max())
                        for rec in ranks)
            shapes = {rec["prefill"]["shape"] for rec in ranks}
            if shapes != {wp["shape"]}:
                raise AssertionError(f"{label}: prefill logits {shapes} vs {wp['shape']}")
            if not pband <= FAM_PREFILL_BAND * pscale:
                raise AssertionError(f"{label}: prefill logits off by {pband} (max |logit| "
                                     f"{pscale}, band {FAM_PREFILL_BAND})")
            log(f"{label} prefill {case['prefill'][0]} x {case['prefill'][1]}: logits "
                f"{wp['shape']}, the last {FAM_PREFILL_TAIL} positions within {pband:.4f} "
                f"({pband / pscale:.2e} of max |logit| {pscale:.2f}, <= {FAM_PREFILL_BAND}) "
                f"of one process in every rank; one-process ms {wp['ms']:.1f} | {card}")
            out.update(prefill_band=pband, prefill_scale=pscale, want_prefill_ms=wp["ms"])
        # decode: the band over the teacher-forced prompt, then the greedy tokens
        got_l, want_l = ranks[0]["decode"]["logits"], want["decode"]["logits"]
        band = float((got_l[:P] - want_l[:P]).abs().max())
        scale = float(want_l[:P].abs().max())
        margins = _logit_margins(want_l)
        wt = want["decode"]["tokens"]
        diverged = None
        for rec in ranks:
            gt = rec["decode"]["tokens"]
            for j in range(new):
                rows = gt[:, j].ne(wt[:, j])
                if not bool(rows.any()):
                    continue
                if bool((margins[P - 1 + j][rows] > 2 * band).any()):
                    raise AssertionError(f"{label}: greedy token {j} differs at a "
                                         f"one-process margin > 2 x band {band}")
                diverged = j if diverged is None else min(diverged, j)
                break
        log(f"{label} decode B {B}, {P}-token prompt + {new} greedy: logit band over "
            f"the prompt {band:.4f} ({band / scale:.2e} of max |logit| {scale:.2f}); greedy "
            f"tokens == one process ({'all' if diverged is None else f'until token {diverged}, where the one-process margin <= 2 x band'}); "
            f"one-process ms a token {_ms_stats(want['decode']['step_ms'][P:])} | {card}")
        out.update(band=band, scale=scale, diverged=diverged,
                   want_ms_token=want["decode"]["step_ms"][P:])
        for r, rec in enumerate(ranks):
            row = {"decode_ms": rec["decode"]["step_ms"],
                   "decode_staged": rec["decode"]["staged"],
                   "decode_peak": rec["decode"]["peak_mem_bytes"],
                   "decode_card_used_mib": rec["decode"]["card_used_mib"]}
            tok_staged = rec["decode"]["staged"][P:]
            per_tok = {k: sum(s.get(k, 0) for s in tok_staged) / len(tok_staged)
                       for k in set().union(*tok_staged)}
            msg = (f"{label} rank {r}: decode ms a token "
                   f"{_ms_stats(rec['decode']['step_ms'][P:])}, staged a token "
                   f"{ {k: round(v) for k, v in sorted(per_tok.items())} } B; ")
            if train:
                tr_ = rec["train"]
                sp = tr_["split"][1:] or tr_["split"]
                mean = lambda k: sum(x.get(k, 0.0) for x in sp) / len(sp)
                row.update(step_ms=tr_["step_ms"], split=tr_["split"], staged=tr_["staged"],
                           train_peak=tr_["peak_mem_bytes"],
                           train_card_used_mib=tr_["card_used_mib"])
                msg += (f"train step_ms {[round(x, 1) for x in tr_['step_ms']]}, steps "
                        f"1-{GSPMD_STEPS - 1} mean split= forward + backward "
                        f"{mean('fwd_bwd'):.1f} ms, gradient redistribute "
                        f"{mean('grad_sync'):.1f} ms, update {mean('update'):.1f} ms; "
                        f"staged a step {tr_['staged'][-1]} B; train peak "
                        f"{tr_['peak_mem_bytes'] / 2**30:.2f} GiB, card used "
                        f"{tr_['card_used_mib']:.0f} MiB; ")
            if case.get("prefill"):
                row.update(prefill_ms=rec["prefill"]["ms"],
                           prefill_staged=rec["prefill"]["staged"])
                msg += (f"prefill {rec['prefill']['ms']:.1f} ms, staged "
                        f"{rec['prefill']['staged']} B; ")
            msg += (f"decode peak {rec['decode']['peak_mem_bytes'] / 2**30:.2f} GiB, card "
                    f"used {rec['decode']['card_used_mib']:.0f} MiB | {card}")
            log(msg)
            out["ranks"].append(row)
        report[label] = out
        del ranks, want
    return report


# ---------------------------------------------------------------------------
# phase 15 e: the dry run, its traced bytes held against the ranks' staged ones
# ---------------------------------------------------------------------------

#: [dryrun] a): the dry run's CLI on the 256-rank production pod, a combo
#: and one the skip rule keeps out
DRYRUN_CLI = (["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh", "pod",
               "--no-extrapolate"],
              ["--arch", "qwen2-0.5b", "--shape", "long_500k", "--mesh", "pod"])


def _dryrun_trace(cfg, shape, mesh, sync) -> dict:
    from repro_torch.launch.dryrun import lower_module

    tr = lower_module(cfg, shape, mesh, sync)
    rec = tr.recorder
    return {"staged": rec.staged_by_op(), "schedule": rec.counts(),
            "temp": rec.peak, "argument": tr.argument_bytes, "s": tr.seconds}


def _dryrun_worker(out_path: str) -> None:
    """The [dryrun] subprocess (no card, no kernel; ``meta`` tensors only):
    a) the CLI runs of ``DRYRUN_CLI``, in this process one after the other;
    b) on a fake world of 4, ``lower_module`` over each mesh case phase 15
    measures, on its config, depth, dtype, batch and mesh: [gspmd]'s step,
    c)'s training steps, and every c) case's prefill and decode token.
    Writes the records to ``out_path`` as JSON."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh_over_world, join_trace_world

    out = {"cli": [], "traces": {}}
    for i, argv in enumerate(DRYRUN_CLI):
        path = f"{out_path}.cli{i}.json"
        t0 = time.perf_counter()
        rc = dryrun.main(argv + ["--out", path])
        out["cli"].append({"argv": argv, "rc": rc, "s": time.perf_counter() - t0,
                           "result": json.loads(Path(path).read_text())})
    join_trace_world(4)
    meshes = {}

    def mesh_of(shape, axes):
        if (shape, axes) not in meshes:
            meshes[(shape, axes)] = _mesh_over_world(shape, axes, "meta", "[dryrun]")
        return meshes[(shape, axes)]

    model, _, sync, _ = _gspmd_case(GSPMD_FULL)
    out["traces"]["[gspmd] step"] = _dryrun_trace(
        model.cfg, InputShape("train", 512, GSPMD_FULL_BATCH, "train"),
        mesh_of((2, 2), _gspmd_axes((2, 2))), sync)
    sync = SyncConfig(fused_update=False, flat_exchange=False)
    for case in GSPMD_FAMILIES_C:
        cfg, mesh = _fam_full_cfg(case), mesh_of(case["mesh"], case["axes"])
        if case["train"]:
            B, S = case["train"]
            out["traces"][f"{case['name']} step"] = _dryrun_trace(
                cfg, InputShape("train", S, B, "train"), mesh, sync)
        B, S = case["prefill"]
        out["traces"][f"{case['name']} prefill"] = _dryrun_trace(
            cfg, InputShape("prefill", S, B, "prefill"), mesh, sync)
        out["traces"][f"{case['name']} token"] = _dryrun_trace(
            cfg, InputShape("decode", case["prompt"] + case["new"], case["batch"],
                            "decode"), mesh, sync)
    Path(out_path).write_text(json.dumps(out))


def start_dryrun() -> tuple:
    """The [dryrun] subprocess, started at the lowest priority (it
    takes the cores the ranks leave idle; its output to a log beside its
    records, under build/): -> (process, records path, log path)."""
    work = ROOT / "build" / "dryrun"
    work.mkdir(parents=True, exist_ok=True)
    path, log_path = work / "records.json", work / "dryrun.log"
    for f in work.iterdir():
        f.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import os; os.nice(19); import chip_smoke; "
             f"chip_smoke._dryrun_worker({str(path)!r})"],
            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    # a phase that fails before [dryrun] reads it leaves no process behind
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path, log_path


def _dryrun_hold(label, traced: dict, measured: list) -> None:
    for j, got in enumerate(measured):
        if got != traced:
            raise AssertionError(f"{label} {j}: the ranks staged {got} B, the dry run "
                                 f"traced {traced} B")


def phase_dryrun(card, job, gspmd0, fam0) -> dict:
    """[dryrun]: the subprocess of ``start_dryrun`` (``job``) must have
    exited 0 with a) both CLI runs at 0 (the combo traced, the skip combo
    skipped) and b) every traced case's collectives, as staged bytes by
    op, ``==`` rank 0's ``LinkStats.by_op`` for each measured step,
    prefill and token: [gspmd]'s (``gspmd0``, its record) and c)'s
    (``fam0``, rank 0's records of b) and c) in case order). The traced
    argument + temp bytes of a step are printed beside the rank's measured
    peak, as a figure only."""
    proc, path, log_path = job
    rc = proc.wait(timeout=600)
    text = log_path.read_text()
    for line in text.splitlines():
        if line.startswith("[dryrun]"):
            log(f"{line} | CPU trace on the card's host")
    if rc != 0:
        raise AssertionError(f"[dryrun] the subprocess exited {rc}:\n{text[-4000:]}")
    rec = json.loads(path.read_text())
    for cli in rec["cli"]:
        res = cli["result"][0]
        if cli["rc"] != 0 or "error" in res:
            raise AssertionError(f"[dryrun] {cli['argv']} exited {cli['rc']}: {res}")
    combo, skip = (c["result"][0] for c in rec["cli"])
    if "skipped" not in skip or "skipped" in combo:
        raise AssertionError(f"[dryrun] skip rule: {skip}, combo {combo.get('skipped')}")
    log(f"[dryrun] a) {combo['arch']} {combo['shape']} on {combo['chips']} fake ranks "
        f"{combo['mesh']}: traced in {combo['lower_s']} s, schedule "
        f"{combo['collective_schedule']}, memory {combo['memory']}; {skip['arch']} "
        f"{skip['shape']} skipped ({skip['skipped']}); CLI seconds "
        f"{[round(c['s'], 1) for c in rec['cli']]}")
    traces = rec["traces"]
    measured = {"[gspmd] step": (gspmd0["staged_by_op"], gspmd0["peak_mem_bytes"])}
    cases = GSPMD_FAMILIES_FULL + GSPMD_FAMILIES_C
    for case in GSPMD_FAMILIES_C:
        r = fam0[cases.index(case)]
        if case["train"]:
            measured[f"{case['name']} step"] = (r["train"]["staged"],
                                                r["train"]["peak_mem_bytes"])
        measured[f"{case['name']} prefill"] = ([r["prefill"]["staged"]], None)
        measured[f"{case['name']} token"] = (r["decode"]["staged"], None)
    if set(measured) != set(traces):
        raise AssertionError(f"[dryrun] traced {sorted(traces)} vs measured {sorted(measured)}")
    report = {"cli": [{k: c[k] for k in ("argv", "rc", "s")} for c in rec["cli"]],
              "combo": combo}
    for name, (runs, peak) in measured.items():
        tr = traces[name]
        label = f"[dryrun] b) {name}"
        _dryrun_hold(label, tr["staged"], runs)
        mem = (f"; traced argument + temp {(tr['argument'] + tr['temp']) / 2**30:.2f} GiB "
               f"beside the rank's measured peak {peak / 2**30:.2f} GiB (a figure only)"
               if peak is not None else "")
        log(f"{label}: traced staged bytes {tr['staged']} == rank 0's LinkStats.by_op "
            f"in all {len(runs)} measured run(s); schedule {tr['schedule']}; traced in "
            f"{tr['s']:.1f} s{mem} | {card}")
        report[name] = {"staged": tr["staged"], "runs": len(runs), "schedule": tr["schedule"],
                        "temp": tr["temp"], "argument": tr["argument"], "peak": peak,
                        "trace_s": tr["s"]}
    return report


# ---------------------------------------------------------------------------
# phase 16: remat honoured, and the reference's three examples as modules
# ---------------------------------------------------------------------------

#: [remat]: full-width qwen2-0.5b, one sequence of train_4k's length a card
REMAT_BATCH, REMAT_SEQ = 1, 4096
REMAT_STEPS = 3


def phase_remat(dev, card) -> dict:
    """Full-width qwen2-0.5b, 1 x 4096, momentum SGD on the main path:
    ``REMAT_STEPS`` steps with ``remat=True`` and as many with
    ``remat=False``, in turns (on, off, on, ...), from the same weights and
    batches. Each step's peak (``max_memory_allocated`` after a reset just
    before it) beside what was resident as it began (both runs' states);
    then one forward + backward of each run alone (``make_grad_fn``), its
    peak above what was resident: remat's own lever, which must be lower
    with remat. Losses, the updated params' max abs difference, the median
    steady step (steps 2 on) of each run, and one profiled step of the
    remat run (device busy, top kernels); ``sgd_momentum_flat`` once a
    step, held on one more step's operands."""
    base = _run_cfg()
    opt, sync = sgd_optimizer(0.1, momentum=0.9), SyncConfig()
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=REMAT_SEQ,
                                    batch_size=REMAT_BATCH), device=dev)
    batches = [pipe.batch_at(0, i) for i in range(REMAT_STEPS)]
    runs = {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(base, remat=remat))
        state = make_train_state(model, opt, sync, device=dev)
        if remat is False:                 # the same weights, bit for bit
            state["params"] = tree_map(torch.clone, runs[True]["state"]["params"])
        runs[remat] = dict(model=model, state=state,
                           step=make_train_step(model, opt, sync, device=dev),
                           losses=[], step_ms=[], peak=[], resident=[])
    label = (f"[remat] qwen2-0.5b full width, {base.num_layers} of 24 layers, "
             f"{REMAT_BATCH} x {REMAT_SEQ}")
    reset_counts()
    for batch in batches:
        for remat in (True, False):
            r = runs[remat]
            torch.cuda.synchronize()
            r["resident"].append(torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r["state"], met = r["step"](r["state"], batch)
            torch.cuda.synchronize()
            r["step_ms"].append((time.perf_counter() - t0) * 1e3)
            r["peak"].append(torch.cuda.max_memory_allocated())
            r["losses"].append(float(met["loss"]))
    got = counts(ALL_KERNELS)
    _check_launches(label, got, {"sgd_momentum_flat": 2 * REMAT_STEPS}, 2 * REMAT_STEPS)
    on, off = runs[True], runs[False]
    for remat, r in runs.items():
        if not all(math.isfinite(x) for x in r["losses"]) or not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"{label} remat={remat}: losses {r['losses']} not falling")
    # a wrong recompute would change the gradient, and the next losses with it
    torch.testing.assert_close(torch.tensor(on["losses"]), torch.tensor(off["losses"]),
                               rtol=1e-3, atol=0)
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in
               zip(tree_leaves(on["state"]["params"]), tree_leaves(off["state"]["params"])))
    for r in runs.values():              # forward + backward alone, not timed
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = make_grad_fn(r["model"])(r["state"]["params"], batches[0])[2]
        torch.cuda.synchronize()
        r["fwd_bwd_peak"] = torch.cuda.max_memory_allocated() - base
        del grads
    if not on["fwd_bwd_peak"] < off["fwd_bwd_peak"]:
        raise AssertionError(f"{label}: forward + backward peaks {on['fwd_bwd_peak']} B "
                             f"above the resident with remat, {off['fwd_bwd_peak']} B "
                             "without: remat saves nothing")
    with _KernelHold() as hold:            # one more step, not timed
        on["step"](on["state"], batches[0])
    # one profiled step, of the run remat makes slower (its trace costs
    # tens of seconds to read on a step of this many ops)
    on["profile"] = _step_profile(on["step"], on["state"], batches[0], top=5)
    gib = lambda xs: [round(x / 2**30, 3) for x in xs]   # noqa: E731
    rep = {"batch": REMAT_BATCH, "seq": REMAT_SEQ, "profile_remat": on["profile"],
           "launches": {k: v for k, v in got.items() if v},
           "params_max_abs_diff": diff, "losses_equal": on["losses"] == off["losses"],
           "hold_max_abs_err": hold.err.get("sgd_momentum_flat")}
    for remat, r in runs.items():
        key = "remat" if remat else "no_remat"
        rep[key] = {"losses": r["losses"], "step_ms": r["step_ms"],
                    "steady_ms_median": float(np.median(r["step_ms"][1:])),
                    "peak_bytes": r["peak"], "resident_bytes": r["resident"],
                    "fwd_bwd_peak_above_resident_bytes": r["fwd_bwd_peak"]}
        log(f"{label} remat={remat}: losses {r['losses']}; step ms "
            f"{[round(x, 1) for x in r['step_ms']]} (steady median "
            f"{rep[key]['steady_ms_median']:.1f}); step peak {gib(r['peak'])} GiB over "
            f"{gib(r['resident'])} GiB resident as each step began; forward + "
            f"backward alone {r['fwd_bwd_peak'] / 2**30:.3f} GiB above the resident "
            f"| {card}")
    log(f"{label}: losses {'==' if rep['losses_equal'] else '!='} between the runs; "
        f"updated params max abs diff {diff}; forward + backward peak "
        f"{on['fwd_bwd_peak'] / 2**30:.3f} GiB with remat against "
        f"{off['fwd_bwd_peak'] / 2**30:.3f} GiB without; step peak "
        f"{max(on['peak']) / 2**30:.3f} GiB against {max(off['peak']) / 2**30:.3f}; a "
        f"profiled step with remat: device busy {on['profile']['busy_ms']} of "
        f"{on['profile']['wall_ms']:.1f} ms, top kernels (name, ms, count) "
        f"{on['profile']['top_kernels_ms']}; launches "
        f"{rep['launches']}; kernel hold ({'; '.join(hold.calls)}) == plain: "
        f"max_abs_err {rep['hold_max_abs_err']} | {card}")
    del runs, on, off
    torch.cuda.empty_cache()
    return rep


def _example(label, main_fn, argv) -> tuple:
    """``main_fn(argv)`` with what it prints logged under ``label``; ->
    (its result, wall s, the printed lines, launches counted)."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main_fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    for ln in lines:
        log(f"{label} | {ln}")
    launches = {k: v for k, v in counts(ALL_KERNELS).items() if v}
    log(f"{label}: {wall:.1f} s wall, launches {launches}")
    return out, wall, lines, launches


def phase_examples(card) -> dict:
    """The three example modules' ``main`` on the card (their default
    device), reduced: quickstart 6 steps, esgd_multipod 8 steps with an
    exchange every 4 on both drivers, serve_batched as it is. Each ran on
    the card, its losses fell, its tokens lie in the model's vocab, and
    the served rate names the card."""
    from repro_torch.launch import esgd_multipod, quickstart, serve_batched

    rep = {}
    q, wall, lines, launches = _example("[examples] quickstart", quickstart.main,
                                        ["--steps", "6"])
    vocab = q["model"].cfg.vocab_size
    if (q["device"].type != "cuda" or not q["losses"][-1] < q["losses"][0]
            or not 0 <= int(q["tokens"].min()) <= int(q["tokens"].max()) < vocab
            or not any(ln.startswith("checkpoint round-trip ok") for ln in lines)
            or launches != {"sgd_momentum_flat": 6}):
        raise AssertionError(f"[examples] quickstart: device {q['device']}, losses "
                             f"{q['losses']}, tokens {q['tokens'].tolist()}, launches "
                             f"{launches}")
    rep["quickstart"] = {"losses": q["losses"], "wall_s": wall, "launches": launches}
    for driver in ("vmap", "shard"):
        e, wall, lines, launches = _example(
            f"[examples] esgd_multipod --driver {driver}", esgd_multipod.main,
            ["--steps", "8", "--interval", "4", "--driver", driver])
        finite = all(bool(torch.isfinite(a).all()) for a in tree_leaves(e["params"]))
        if (e["device"].type != "cuda" or not finite or e["syncs"] != (8, 2)
                or not e["sgd_losses"][-1] < e["sgd_losses"][0]
                or not e["esgd_losses"][-1] < e["esgd_losses"][0]):
            raise AssertionError(f"[examples] esgd_multipod {driver}: device "
                                 f"{e['device']}, losses {e['sgd_losses']} / "
                                 f"{e['esgd_losses']}, finite {finite}")
        rep[f"esgd_{driver}"] = {"sgd_losses": e["sgd_losses"],
                                 "esgd_losses": e["esgd_losses"], "wall_s": wall,
                                 "launches": launches}
    s, wall, lines, launches = _example("[examples] serve_batched", serve_batched.main, [])
    name = torch.cuda.get_device_name(0)
    for arch, res in s.items():
        toks = res["tokens"]
        if (toks.device.type != "cuda" or tuple(toks.shape) != (4, 16)
                or not 0 <= int(toks.min()) <= int(toks.max()) < res["vocab_size"]):
            raise AssertionError(f"[examples] serve_batched {arch}: tokens on "
                                 f"{toks.device}, {toks.tolist()}")
    if len(lines) != 3 or not all(f"on {name})" in ln for ln in lines) or launches:
        raise AssertionError(f"[examples] serve_batched: lines {lines}, launches {launches}")
    rep["serve_batched"] = {arch: {"seconds": res["seconds"],
                                   "tokens_per_s": res["tokens"].numel() / res["seconds"]}
                            for arch, res in s.items()}
    rep["serve_batched"]["wall_s"] = wall
    log(f"[examples] all three on the card: losses falling, tokens in the vocab | {card}")
    return rep


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
    kernels.update(phase_hop_kernels(dev))
    log(f"[kernels] phases 1-2 took {time.perf_counter() - T_START:.1f} s since start")
    t0 = time.perf_counter()
    phase_small_reference(dev)
    launches, _, params = phase_slice(dev)
    phase_checkpoint(params)
    del params
    torch.cuda.empty_cache()
    log(f"[slice] phases 3-4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_small_esgd(dev)
    esgd_launches, report = phase_esgd(dev)
    log(f"[esgd] phase 5 took {time.perf_counter() - t0:.1f} s")
    for name, c in esgd_launches.items():
        launches.setdefault(name, c)
    t0 = time.perf_counter()
    phase_ps_small(dev)
    ps_launches, ps_errs, _ = phase_ps(dev)
    log(f"[ps] phase 6 took {time.perf_counter() - t0:.1f} s")
    launches.update(ps_launches)
    for name, e in ps_errs.items():     # worst hold: phase 2 or the run's operands
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)
    t0 = time.perf_counter()
    phase_faults_small(dev)
    fault_launches, fault_errs, _ = phase_faults(dev)
    log(f"[faults] phase 7 took {time.perf_counter() - t0:.1f} s")
    launches.update(fault_launches)
    for name, e in fault_errs.items():  # worst hold: phase 2 or the [faults] run
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)
    t0 = time.perf_counter()
    overlap_errs = phase_overlap_small(dev)
    _, overlap_full_errs, overlap_report = phase_overlap(dev)
    log(f"[overlap] phase 8 took {time.perf_counter() - t0:.1f} s")
    for name, e in overlap_full_errs.items():
        overlap_errs[name] = max(overlap_errs.get(name, 0.0), e)
    for name, e in overlap_errs.items():  # worst hold: phase 2 or the overlapped runs
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)
    for name, key in (("sgd_momentum_flat", "sgd_max_abs_err"),
                      ("elastic_center_flat", "center_max_abs_err")):
        row = kernels[name]                 # worst hold: phase 2 or a run's operands
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [r[key] for r in report.values() if key in r])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serve_small(dev)
    serve = {"serve": phase_serve(dev), "configs": phase_serve_configs(dev)}
    log("[serve] " + json.dumps(serve, default=str))
    log(f"[serve] the serve phases took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_families_small(dev)
    log(f"[families:small] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    families = phase_families(dev)
    log("[families] " + json.dumps(families, default=str))
    log(f"[families] took {time.perf_counter() - t0:.1f} s")
    kernels["sgd_momentum_flat"]["max_abs_err"] = max(
        [kernels["sgd_momentum_flat"]["max_abs_err"]]
        + [r["hold_max_abs_err"] for r in families["train"].values()])
    for name in ("whisper-base", "paligemma-3b"):    # slice 10's trained families
        launches["sgd_momentum_flat"] += families["train"][name]["launches"][
            "sgd_momentum_flat"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_resnet_small(dev)
    log(f"[resnet:small] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resnet_launches, resnet_errs, resnet = phase_resnet(dev)
    log("[resnet] " + json.dumps(resnet, default=str))
    log(f"[resnet] took {time.perf_counter() - t0:.1f} s")
    for name, c in resnet_launches.items():     # the int8 run's launches add
        launches[name] += c
    for name, e in resnet_errs.items():         # worst hold: earlier or the run's
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)
    t0 = time.perf_counter()
    phase_net_small(dev)
    log(f"[net:small] took {time.perf_counter() - t0:.1f} s | {card}")
    t0 = time.perf_counter()
    net_launches, net_errs, net = phase_net(dev, card)
    log("[net] " + json.dumps(net, default=str))
    log(f"[net] took {time.perf_counter() - t0:.1f} s | {card}")
    for name, c in net_launches.items():        # the dist_esgd int8 run's add
        launches[name] += c
    for name, e in net_errs.items():            # worst hold: earlier or the run's
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], e)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch_small = phase_launch_small(dev, card)
    log("[launch:small] " + json.dumps(launch_small, default=str))
    log(f"[launch:small] took {time.perf_counter() - t0:.1f} s | {card}")
    t1 = time.perf_counter()
    sgd_row = kernels["sgd_momentum_flat"]
    launch_sgd, launch_err, launch = phase_launch(dev, card, dict(sgd_row, bytes=20 * n))
    log("[launch] " + json.dumps(launch, default=str))
    log(f"[launch] took {time.perf_counter() - t1:.1f} s; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    launches["sgd_momentum_flat"] += launch_sgd      # the full-width run's 3
    sgd_row["max_abs_err"] = max(sgd_row["max_abs_err"], launch_err)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_small = phase_mesh_small(dev, card)
    log("[mesh:small] " + json.dumps(mesh_small, default=str))
    log(f"[mesh:small] took {time.perf_counter() - t0:.1f} s | {card}")
    t1 = time.perf_counter()
    mesh_sgd, mesh_err, mesh = phase_mesh(dev, card, overlap_report)
    log("[mesh] " + json.dumps(mesh, default=str))
    log(f"[mesh] took {time.perf_counter() - t1:.1f} s; phase 14 took "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    launches["sgd_momentum_flat"] += mesh_sgd        # 4 ranks x 3 steps x 2 runs
    sgd_row["max_abs_err"] = max(sgd_row["max_abs_err"], mesh_err)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the dry run's subprocess (CPU only) beside the correctness runs,
    # which run side by side (their wall times are not measurements: the
    # host's 8 cores bind them), then the full-width ones in one spawn
    dry = start_dryrun()
    with ThreadPoolExecutor(1) as ex:
        multi = ex.submit(phase_multidevice, card)
        fam_small, small_ranks = phase_gspmd_families_small(card)
        multidevice = multi.result()
    gspmd_small = phase_gspmd_small(card, small_ranks)
    del small_ranks
    log("[gspmd:small] " + json.dumps(gspmd_small, default=str))
    log("[multidevice] " + json.dumps(multidevice, default=str))
    log("[gspmd:families] a) " + json.dumps(fam_small, default=str))
    log(f"[gspmd:small], [multidevice] and [gspmd:families] a) took "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    t1 = time.perf_counter()
    full = spawn_full_width(card)
    gspmd = phase_gspmd(card, [r["gspmd"] for r in full])
    log("[gspmd] " + json.dumps(gspmd, default=str))
    fam = phase_gspmd_families(card, [r["families"] for r in full])
    log("[gspmd:families] b) and c) " + json.dumps(fam, default=str))
    log(f"[gspmd] and [gspmd:families] b) and c) took {time.perf_counter() - t1:.1f} s | "
        f"{card}")
    t1 = time.perf_counter()
    dryrun = phase_dryrun(card, dry, full[0]["gspmd"], full[0]["families"])
    del full
    log("[dryrun] " + json.dumps(dryrun, default=str))
    log(f"[dryrun] waited {time.perf_counter() - t1:.1f} s for its subprocess; phase 15 "
        f"took {time.perf_counter() - t0:.1f} s | {card}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    remat = phase_remat(dev, card)
    log("[remat] " + json.dumps(remat, default=str))
    log(f"[remat] took {time.perf_counter() - t0:.1f} s | {card}")
    launches["sgd_momentum_flat"] += remat["launches"]["sgd_momentum_flat"]
    sgd_row["max_abs_err"] = max(sgd_row["max_abs_err"], remat["hold_max_abs_err"])
    t1 = time.perf_counter()
    examples = phase_examples(card)
    log("[examples] " + json.dumps(examples, default=str))
    log(f"[examples] took {time.perf_counter() - t1:.1f} s; phase 16 took "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    log(f"[smoke] phases 1-16 took {time.perf_counter() - T_START:.1f} s | {card}")
    log("[kernels] per-hop codec launches on the int8 runs: " + json.dumps(HOP_RUNS))
    for name in HOP_KERNELS:        # the int8 runs of [esgd], [overlap], [resnet], [net]
        launches[name] = sum(run[name] for run in HOP_RUNS.values())
    for name, row in kernels.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
