#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on past its own):

  1. device   require CUDA, print the card's name and power limit, TF32 off
  2. kernels  build each Triton kernel of the main path from this
              checkout (cache in build/), run it at the main path's shape
              (the full-width qwen2-0.5b state shard, n = 494,147,584) and
              hold it against its plain PyTorch version on the same
              tensors; time kernel, plain version and a one-call PyTorch
              yardstick the port never calls (torch._fused_*)
  3. slice    a) the reduced model, 3 steps per optimizer on the card
                 against the same steps on the CPU (a small reference)
              b) full-width qwen2-0.5b in bf16, batch 8 x seq 512, through
                 make_train_state -> make_train_step -> FlatEngine, a few
                 mpi-SGD steps each for sgd, adamw and adagrad, with the
                 kernels' launch counts set to 0 just before and read just
                 after; step time, its breakdown, and peak memory
  4. ckpt     npz checkpoint round trip of the trained params

Prints a ``kernels`` JSON line, the card line, and last the ok line.
"""
from __future__ import annotations

import json
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
from repro_torch.core import flatbuf  # noqa: E402
from repro_torch.core.sync_engine import make_sync_engine  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels.fused_optim import fused_optim as fo  # noqa: E402
from repro_torch.kernels.fused_sgd import fused_sgd as fs  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    grad_spec, make_grad_fn, make_train_state, make_train_step)
from repro_torch.models.model import build_model  # noqa: E402
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


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


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


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda")
    n = flatbuf.shard_size(grad_spec(build_model(get_config("qwen2-0.5b"))), 1, 2)
    kernels = phase_kernels(n, dev)
    phase_small_reference(dev)
    launches, _, params = phase_slice(dev)
    phase_checkpoint(params)
    for name, row in kernels.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
