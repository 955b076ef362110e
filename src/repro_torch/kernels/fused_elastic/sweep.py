"""Sweep the CUDA one-side elastic kernel's tile on the card.

  PYTHONPATH=src python -m repro_torch.kernels.fused_elastic.sweep [--check] [--json PATH]

Builds copies of ``csrc/fused_elastic.cu`` with other values of ``TILE``
(elements per CTA; ``THREADS`` = TILE / 4, so 2048 / THREADS CTAs fit an
SM), every build at once into ``build/cuda/``; holds each against the
plain version at the full-width packed buffer (f32, n = 494,147,584); and
times eqs. (3) and (2) interleaved with ``torch.lerp``, their yardstick;
then, for the card's reachable HBM rate, ``torch.add`` (the same 12 B per
element) and a copy (8 B), each in turns with the kernel. Prints one line
per point, and writes them all to ``--json PATH`` when given.

``--check``: the kernels as built from the source, for every (w, w̃)
dtype pair, both sides, both α of the tests and ragged sizes, equal to
the plain versions; nothing timed. Needs a CUDA card.
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


def _launch(lib, side: str, w, c, alpha):
    out = torch.empty_like(c if side == "server" else w)
    fn = getattr(lib, f"elastic_{side}_flat_cuda")
    err = fn(alpha.data_ptr(), w.data_ptr(), c.data_ptr(), out.data_ptr(), w.numel(),
             int(w.dtype == torch.bfloat16), int(c.dtype == torch.bfloat16),
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
        for wd in dtypes:
            for cd in dtypes:
                w, c = w32.to(wd), c32.to(cd)
                for a in (0.5, 0.5 / 3):
                    alpha = torch.tensor(a, device="cuda")
                    for side in ("client", "server"):
                        want = _plain(side)(w, c, alpha)
                        got = _launch(lib, side, w, c, alpha)
                        torch.cuda.synchronize()
                        if got.dtype != want.dtype or not torch.equal(got, want):
                            bad = int((got.float() != want.float()).sum())
                            raise AssertionError(f"{side} n={n} w={wd} c={cd} a={a}: "
                                                 f"{bad} elements differ")
        print(f"[check] n={n}: 4 dtype pairs x 2 sides x 2 alphas == plain", flush=True)


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
    want = {side: _plain(side)(w, c, alpha) for side in ("client", "server")}
    lerp = {"client": lambda: torch.lerp(w, c, a), "server": lambda: torch.lerp(c, w, a)}
    bound_ms = 12 * N / HBM_BYTES_PER_S * 1e3
    points = []

    def run(label, lib, extra):
        for side in ("client", "server"):
            got = _launch(lib, side, w, c, alpha)
            torch.cuda.synchronize()
            if not torch.equal(got, want[side]):
                raise AssertionError(f"{label} {side}: kernel != plain")
            del got
            t = interleaved_ms(lambda: _launch(lib, side, w, c, alpha), lerp[side])
            points.append({"side": side, **extra, "ms": t["kernel"],
                           "lerp_ms": t["library"], "bound_ms": bound_ms})
            print(f"[sweep] {label} {side}: kernel {spread(t['kernel'])} ms, lerp "
                  f"{spread(t['library'])} ms, ratio "
                  f"{t['kernel']['median'] / t['library']['median']:.4f}, "
                  f"{bound_ms / t['kernel']['median'] * 100:.1f} % of the "
                  f"{bound_ms:.4f} ms bound", flush=True)

    for t, vlib in libs.items():
        run(f"TILE={t} THREADS={t // 4} ({8192 // t} CTAs/SM)", vlib, {"tile": t})
    run(f"as built: TILE={tile}", lib, {"tile": tile, "as_built": True})
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
    if args.json:
        args.json.write_text(json.dumps({"card": card, "n": N, "points": points}, indent=1))


if __name__ == "__main__":
    main()
