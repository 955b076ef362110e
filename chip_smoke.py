#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on past its own):

  1. device   require CUDA, print the card's name and power limit, TF32 off
  2. kernels  build each Triton kernel of the paths from this checkout
              (cache in build/), run it at the shape its path gives it (the
              full-width qwen2-0.5b buffers, n = 494,147,584 per device)
              and hold it against its plain PyTorch version on the same
              tensors; time kernel, plain version and, where one exists, a
              one-call PyTorch yardstick the port never calls
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

Phase 2 also holds and times the PS tier's four kernels (quantize_wire,
dequantize_wire, elastic_client_flat, elastic_server_flat) at the packed
full-width buffer, n = 494,147,584.

Prints a ``kernels`` JSON line, the card line, and last the ok line.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
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
from repro_torch.kernels.fused_elastic import fused_elastic as fe  # noqa: E402
from repro_torch.kernels.fused_optim import fused_optim as fo  # noqa: E402
from repro_torch.kernels.fused_sgd import fused_sgd as fs  # noqa: E402
from repro_torch.kernels.quant_bucket import quant_bucket as qb  # noqa: E402
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
#: slice 2's kernels; ``rtol``/``atol`` hold the f32 outputs (FMA and
#: f64-emulated FMA agree but for a rare double rounding), bf16 outputs
#: are held to 1 bf16 ulp beyond ``atol``
ELASTIC_KERNELS = {
    "elastic_client_diff_flat": dict(
        wrapper=fe.elastic_client_diff_flat, plain=fe.elastic_client_diff_flat_plain,
        source="src/repro_torch/kernels/fused_elastic/fused_elastic.py",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:114",
        rtol=1e-6, atol=1e-7),
    "elastic_center_flat": dict(
        wrapper=fe.elastic_center_flat, plain=fe.elastic_center_flat_plain,
        source="src/repro_torch/kernels/fused_elastic/fused_elastic.py",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:131",
        rtol=1e-6, atol=1e-7),
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
        source="src/repro_torch/kernels/fused_elastic/fused_elastic.py",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:83",
        flops_per_elem=3),
    "elastic_server_flat": dict(
        wrapper=fe.elastic_server_flat, plain=fe.elastic_server_flat_plain,
        source="src/repro_torch/kernels/fused_elastic/fused_elastic.py",
        replaces="src/repro/kernels/fused_elastic/fused_elastic.py:97",
        flops_per_elem=3),
}
ALL_KERNELS = {**KERNELS, **ELASTIC_KERNELS, **PS_KERNELS}
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
            ms = cuda_ms(lambda: wrapper(p, state, g, hp), reps=20)
            plain_ms = cuda_ms(lambda: plain(p, state, g, hp), reps=5, warmup=1)
            lib = _library_call(name, p, state, g, hp) if sd == torch.float32 else None
            library_ms = cuda_ms(lib, reps=20) if lib is not None else None
            moved = 2 * nbytes(p, state) + nbytes(g)   # read p,s,g; write p,s
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = k["flops_per_elem"] * n / F32_FLOPS_PER_S * 1e3
            tag = "f32" if sd == torch.float32 else "bf16"
            log(f"[kernels] {name} state={tag} n={n} first call {build_s:.2f} s "
                f"(build + run) max_abs_err={err:.3e} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms} "
                f"bytes={moved} bound_ms={max(bytes_ms, ops_ms):.4f}")
            if sd == torch.float32:
                results[name] = {
                    "name": name, "route": "triton", "source": k["source"],
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
            err = max(_hold(g, w, k["rtol"], k["atol"], g.dtype)
                      for g, w in zip(got, want))
            moved = nbytes(*args) + nbytes(*got)
            del got, want
            ms = cuda_ms(lambda: wrapper(*args, alpha), reps=10)
            plain_ms = cuda_ms(lambda: _plain_rows(plain, args, alpha),
                               reps=2, warmup=1)
            library_ms = None
            if name == "elastic_center_flat":
                a = float(alpha)
                library_ms = cuda_ms(lambda: torch.add(args[0], args[1], alpha=a),
                                     reps=10)
            elems = args[0].numel()
            flops = {"elastic_client_diff_flat": 3, "elastic_center_flat": 2,
                     "elastic_exchange_flat_mc": 4}[name] * elems
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOPS_PER_S * 1e3
            tag = "f32" if w_dtype == torch.float32 else "bf16"
            log(f"[kernels] {name} w={tag} shape={tuple(args[0].shape)} first "
                f"call {build_s:.2f} s (build + run) max_abs_err={err:.3e} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms} "
                f"bytes={moved} bound_ms={max(bytes_ms, ops_ms):.4f}")
            if w_dtype == torch.float32:
                results[name] = {
                    "name": name, "route": "triton", "source": k["source"],
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
    want = k["plain"](*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"{name}: kernel != plain ({bad} elements of "
                                 f"{tuple(w.shape)} {w.dtype})")
    return max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


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
        ms = cuda_ms(lambda: k["wrapper"](*args), reps=10)
        plain_ms = cuda_ms(lambda: k["plain"](*args), reps=2, warmup=1)
        library_ms, a = None, float(alpha)
        if name == "elastic_client_flat":      # w + α (w̃ − w) = eq. (3)
            library_ms = cuda_ms(lambda: torch.lerp(x, c, a), reps=10)
        elif name == "elastic_server_flat":    # w̃ + α (w − w̃) = eq. (2)
            library_ms = cuda_ms(lambda: torch.lerp(c, x, a), reps=10)
        else:
            log(f"[kernels] {name}: no library yardstick — no one PyTorch call "
                "computes the per-128-bucket absmax int8 codec")
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = k["flops_per_elem"] * n / F32_FLOPS_PER_S * 1e3
        log(f"[kernels] {name} n={n} first call {build_s:.2f} s (build + run) "
            f"max_abs_err={err:.3e} (all outputs ==) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms} bytes={moved} "
            f"bound_ms={max(bytes_ms, ops_ms):.4f}")
        results[name] = {
            "name": name, "route": "triton", "source": k["source"],
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
    """Wraps ``algorithms.elastic_client_packed`` for one run and keeps the
    last exchange's operands — the pushed replica (= the client's params)
    and the center as it was before that push — for the holds after it."""

    def __init__(self):
        self.last = None
        self._orig = alg.elastic_client_packed

    def __call__(self, params, center, alpha):
        self.last = (params, center, alpha)
        return self._orig(params, center, alpha)

    def __enter__(self):
        alg.elastic_client_packed = self
        return self

    def __exit__(self, *exc):
        alg.elastic_client_packed = self._orig


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
                        num_clients=cfg.num_clients, wire_dtype=cfg.effective_wire_dtype)
    kv.init("centers", center)
    kv.set_elastic(cfg.esgd_alpha)
    out["push_ms"] = cuda_ms(lambda: kv.push("centers", params), reps=3, warmup=1)
    out["elastic2_ms"] = cuda_ms(
        lambda: alg.elastic_client_packed(params, center, cfg.esgd_alpha), reps=3, warmup=1)
    opt = alg._make_opt(cfg, params)
    state = opt.init(params)
    out["update_ms"] = cuda_ms(lambda: opt.update(g, state, params), reps=3, warmup=1)
    out["exchange_completion_ms"] = sum(out.values())
    out["plain_completion_ms"] = (out["fwd_bwd_ms"] + out["allreduce_ms"]
                                  + out["update_ms"])

    def completion():
        _, grads = alg._client_grad(grad, params, batches, group)
        kv.push("centers", params)
        p = alg.elastic_client_packed(params, kv.value("centers"), cfg.esgd_alpha)
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


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda")
    spec = grad_spec(build_model(get_config("qwen2-0.5b")))
    n = flatbuf.shard_size(spec, 1, 2)
    kernels = phase_kernels(n, dev)
    kernels.update(phase_elastic_kernels(spec, dev))
    kernels.update(phase_ps_kernels(spec, dev))
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
    sgd_row = kernels["sgd_momentum_flat"]    # worst hold: phase 2 or a run's shards
    sgd_row["max_abs_err"] = max([sgd_row["max_abs_err"]]
                                 + [r["sgd_max_abs_err"] for r in report.values()])
    for name, row in kernels.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
