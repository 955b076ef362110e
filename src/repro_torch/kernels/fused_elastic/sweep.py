"""Sweep the CUDA elastic kernel's tile on the card.

  PYTHONPATH=src python -m repro_torch.kernels.fused_elastic.sweep [--check] [--json PATH]

Builds copies of ``csrc/fused_elastic.cu`` with other values of ``TILE``
(elements per CTA; ``THREADS`` = TILE / 4, so 2048 / THREADS CTAs fit an
SM), every build at once into ``build/cuda/``; holds each against the
plain versions; and times, in turns with its one-call yardstick, eqs. (3)
and (2) at the full-width packed buffer (f32, n = 494,147,584) against
``torch.lerp``, and the center pass at the (2, 2) driver's stacked center
shards (4 x 247,073,792 values; c f32, then bf16, the summed differences
f32) against ``torch.add(c, ds, alpha=a)``; then, for the card's
reachable HBM rate, ``torch.add`` (the same 12 B per element) and a copy
(8 B), each in turns with the kernel. Prints one line per point, and
writes them all to ``--json PATH`` when given.

``--check``: the kernels as built from the source, for every operand
dtype pair, all three passes, both α of the tests and ragged sizes, equal
to the plain versions; nothing timed. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.fused_elastic import fused_elastic as fe
from repro_torch.kernels.timing import interleaved_ms, spread

N = 494_147_584                  # the full-width qwen2-0.5b packed buffer
CENTER_SHAPE = (4, 247_073_792)  # the (2, 2) driver's stacked center shards
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet, 700 W
TILES = (1024, 2048, 4096)


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def _variant(tile: int) -> Path:
    src = cuda_build.source_path("fused_elastic").read_text()
    for name, value in (("TILE", tile), ("THREADS", tile // 4)):
        src = re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                     src)
    path = cuda_build.LIB_DIR / "sweep" / f"fused_elastic_T{tile}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def _launch(lib, side: str, x, y, alpha):
    """One launch of ``elastic_<side>_flat_cuda`` from ``lib`` on (x, y):
    (w, w̃) for the client and server passes, (w̃, Σ) for the center."""
    out = torch.empty_like(y if side == "server" else x)
    fn = getattr(lib, f"elastic_{side}_flat_cuda")
    err = fn(alpha.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
             int(x.dtype == torch.bfloat16), int(y.dtype == torch.bfloat16),
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, side)
    return out


def _plain(side):
    return getattr(fe, f"elastic_{side}_flat_plain")


def check(lib, tile: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = (torch.float32, torch.bfloat16)
    for n in (1, 3, 4095, 4096, 4097, 2 * 132 * tile + 17, 3 * 132 * tile + 8):
        w32 = torch.randn(n, generator=gen, device="cuda")
        c32 = w32 + 0.1 * torch.randn(n, generator=gen, device="cuda")
        # the center pass: (w̃, Σ of two clients' differences)
        operands = {"client": (w32, c32), "server": (w32, c32),
                    "center": (c32, 0.1 * torch.randn(n, generator=gen, device="cuda")
                               + 0.1 * torch.randn(n, generator=gen, device="cuda"))}
        for side, (x32, y32) in operands.items():
            for xd in dtypes:
                for yd in dtypes:
                    x, y = x32.to(xd), y32.to(yd)
                    for a in (0.5, 0.5 / 3):
                        alpha = torch.tensor(a, device="cuda")
                        want = _plain(side)(x, y, alpha)
                        got = _launch(lib, side, x, y, alpha)
                        torch.cuda.synchronize()
                        if got.dtype != want.dtype or not torch.equal(got, want):
                            bad = int((got.float() != want.float()).sum())
                            raise AssertionError(f"{side} n={n} x={xd} y={yd} a={a}: "
                                                 f"{bad} elements differ")
        print(f"[check] n={n}: 4 dtype pairs x 3 passes x 2 alphas == plain", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    nvcc = cuda_build.find_nvcc()
    print(f"[sweep] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          + subprocess.run([nvcc, "--version"], capture_output=True,
                           text=True).stdout.strip().splitlines()[-1], flush=True)
    t0 = time.perf_counter()
    lib = cuda_build.load_library("fused_elastic")
    print(f"[sweep] built fused_elastic in {time.perf_counter() - t0:.2f} s\n"
          + cuda_build.ptxas_report("fused_elastic"), flush=True)
    tile = _constant(cuda_build.source_path("fused_elastic").read_text(), "TILE")
    if args.check:
        check(lib, tile)
        return

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(TILES)) as pool:
        paths = list(pool.map(lambda t: cuda_build.build(f"fused_elastic_T{t}",
                                                         _variant(t)), TILES))
    print(f"[sweep] built {len(TILES)} variants in {time.perf_counter() - t0:.2f} s",
          flush=True)
    libs = {t: cuda_build.bind(p, cuda_build.SIGNATURES["fused_elastic"])
            for t, p in zip(TILES, paths)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(N, generator=gen, device="cuda")
    c = w + 0.01 * torch.randn(N, generator=gen, device="cuda")
    alpha = torch.tensor(0.5, device="cuda")
    a = float(alpha)
    points = []

    def run(label, lib, extra, cases):
        """``cases``: (pass, tag, x, y, plain result, yardstick name and
        call, bound ms); each held == plain, then timed in turns."""
        for side, tag, x, y, want, (lib_name, library_fn), bound_ms in cases:
            got = _launch(lib, side, x, y, alpha)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{label} {side} {tag}: kernel != plain")
            del got
            t = interleaved_ms(lambda: _launch(lib, side, x, y, alpha), library_fn)
            points.append({"side": side, "operands": tag, **extra, "ms": t["kernel"],
                           "library": lib_name, "library_ms": t["library"],
                           "bound_ms": bound_ms})
            print(f"[sweep] {label} {side} {tag}: kernel {spread(t['kernel'])} ms, "
                  f"{lib_name} {spread(t['library'])} ms, ratio "
                  f"{t['kernel']['median'] / t['library']['median']:.4f}, "
                  f"{bound_ms / t['kernel']['median'] * 100:.1f} % of the "
                  f"{bound_ms:.4f} ms bound", flush=True)

    bound_ms = 12 * N / HBM_BYTES_PER_S * 1e3
    one_side = [
        ("client", "f32 n=%d" % N, w, c, _plain("client")(w, c, alpha),
         ("torch.lerp(w, c, a)", lambda: torch.lerp(w, c, a)), bound_ms),
        ("server", "f32 n=%d" % N, w, c, _plain("server")(w, c, alpha),
         ("torch.lerp(c, w, a)", lambda: torch.lerp(c, w, a)), bound_ms)]
    for t, vlib in libs.items():
        run(f"TILE={t} THREADS={t // 4} ({8192 // t} CTAs/SM)", vlib, {"tile": t}, one_side)
    run(f"as built: TILE={tile}", lib, {"tile": tile, "as_built": True}, one_side)
    # what the card's HBM gives such streams: the same bytes through
    # torch.add, and a plain copy (8 B per element), each in turns with
    # the kernel as built
    o = torch.empty_like(w)
    for name, fn, moved in (("torch.add(w, c, out=o)", lambda: torch.add(w, c, out=o),
                             12 * N),
                            ("o.copy_(w)", lambda: o.copy_(w), 8 * N)):
        t = interleaved_ms(lambda: _launch(lib, "client", w, c, alpha), fn)
        ref_bound = moved / HBM_BYTES_PER_S * 1e3
        points.append({"reference": name, "ms": t["library"], "kernel_ms": t["kernel"],
                       "bound_ms": ref_bound})
        print(f"[sweep] {name}: {spread(t['library'])} ms, "
              f"{ref_bound / t['library']['median'] * 100:.1f} % of its {ref_bound:.4f} ms "
              f"bound ({moved / t['library']['median'] / 1e9:.3f} TB/s); the kernel in "
              f"turns {spread(t['kernel'])} ms", flush=True)
    del w, c, o, one_side
    torch.cuda.empty_cache()

    # the center pass at the (2, 2) driver's shards: c f32 and bf16 against
    # an f32 sum of differences, α = 0.5 / 2 as the driver gives it
    alpha = torch.tensor(0.25, device="cuda")
    a = float(alpha)
    ds = 0.01 * torch.randn(CENTER_SHAPE, generator=gen, device="cuda")
    center = []
    for cd in (torch.float32, torch.bfloat16):
        cc = torch.randn(CENTER_SHAPE, generator=gen, device="cuda").to(cd)
        want = torch.stack([_plain("center")(cc[i], ds[i], alpha)
                            for i in range(CENTER_SHAPE[0])])
        moved = cc.numel() * (2 * cc.element_size() + ds.element_size())
        center.append(("center", f"c {str(cd)[6:]} {CENTER_SHAPE}", cc, ds, want,
                       ("torch.add(c, ds, alpha=a)",
                        lambda cc=cc: torch.add(cc, ds, alpha=a)),
                       moved / HBM_BYTES_PER_S * 1e3))
    for t, vlib in libs.items():
        run(f"TILE={t} THREADS={t // 4} ({8192 // t} CTAs/SM)", vlib, {"tile": t}, center)
    run(f"as built: TILE={tile}", lib, {"tile": tile, "as_built": True}, center)
    if args.json:
        args.json.write_text(json.dumps({"card": card, "n": N, "points": points}, indent=1))


if __name__ == "__main__":
    main()
