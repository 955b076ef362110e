"""Build and bind the port's CUDA C++ kernels: ``nvcc`` into a shared
library with a plain C interface, loaded through ``ctypes``.

Sources live in ``src/repro_torch/csrc/<name>.cu``. ``load_library(name)``
compiles one at its first use in a process for ``sm_90a`` (the H100; an
``sm_90a`` binary runs on no other card) into
``build/cuda/<name>-<hash>.so``, where the hash covers the source bytes
and the command, so an edited source builds anew and an unchanged one is
loaded as it is. The library is written through a temporary file and
``os.replace``, so processes that build at the same moment each see a
whole library. ptxas's report (registers, shared memory, spills) is kept
beside it as ``<library>.ptxas.txt``.

``-cudart shared`` links the CUDA runtime under its soname, so the
library shares the runtime (and its current device) that torch has
already loaded. There is no fallback: a missing ``nvcc``, a failed build
or a card that is not compute capability 9.0 raises ``RuntimeError``.

Every function in ``SIGNATURES`` is bound with its ``argtypes`` and an
``int`` ``restype`` (the ``cudaError_t`` after its launch); without
``argtypes`` ctypes would pass a pointer as a 32-bit int. Each source
also exports ``cuda_error_string(int)``, which ``check`` uses to raise
with CUDA's message.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from ctypes import c_int, c_longlong, c_void_p
from pathlib import Path

import torch

from repro_torch.kernels.common import BUILD_DIR

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
LIB_DIR = BUILD_DIR / "cuda"
#: where ``nvcc`` is looked for after ``PATH`` and ``$CUDA_HOME/bin``
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared", "-Xptxas", "-v")

#: alpha, x, y, out, n, x_bf16, y_bf16, stream
_ELASTIC = (c_void_p, c_void_p, c_void_p, c_void_p, c_longlong, c_int, c_int, c_void_p)
#: per library, every bound function and its argument types: pointers and
#: the stream as ``c_void_p``, element counts as ``c_longlong``, flags as
#: ``c_int``
SIGNATURES = {
    "fused_elastic": {
        "elastic_client_flat_cuda": _ELASTIC,
        "elastic_server_flat_cuda": _ELASTIC,
        "elastic_center_flat_cuda": _ELASTIC,
    },
}


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin``, else under
    ``/usr/local/cuda/bin``; raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME]
    for home in filter(None, homes):
        nvcc = Path(home) / "bin" / "nvcc"
        if nvcc.is_file() and os.access(nvcc, os.X_OK):
            return str(nvcc)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels are built "
                       "from src/repro_torch/csrc at first use and need it")


def library_path(name: str, source: bytes) -> Path:
    """``build/cuda/<name>-<sha256(source bytes + command)[:16]>.so``."""
    digest = hashlib.sha256(source + " ".join(FLAGS).encode()).hexdigest()[:16]
    return LIB_DIR / f"{name}-{digest}.so"


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *FLAGS, "-o", str(output), str(source)]


def build(name: str, source: Path | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``source``) unless its library is
    already built; returns the library's path."""
    source = source_path(name) if source is None else source
    lib = library_path(name, source.read_bytes())
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        done = subprocess.run(nvcc_command(nvcc, source, Path(tmp)),
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({done.returncode}):\n"
                               f"{done.stdout}{done.stderr}")
        Path(f"{lib}.ptxas.txt").write_text(done.stdout + done.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def ptxas_report(name: str) -> str:
    """ptxas's report of the built library (registers, shared memory,
    spills per kernel), or "" before the first build."""
    report = Path(f"{library_path(name, source_path(name).read_bytes())}.ptxas.txt")
    return report.read_text() if report.is_file() else ""


def bind(path: Path, functions: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in functions.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = c_int
    lib.cuda_error_string.argtypes = [c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (first use) and load ``csrc/<name>.cu`` for the current card,
    every function of ``SIGNATURES[name]`` bound."""
    path = build(name)
    capability = torch.cuda.get_device_capability()
    if capability != (9, 0):
        raise RuntimeError(f"{name}: built for sm_90a (H100), the card is "
                           f"compute capability {capability}")
    return bind(path, SIGNATURES[name])


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise with CUDA's message unless the launch returned cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
