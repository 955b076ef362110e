"""The CUDA C++ build route of the port (``kernels/cuda_build``), checked
without a card or ``nvcc``: the ``nvcc`` command and where it reads and
writes, the library's content hash, the refusal without ``nvcc`` (no
fallback), every ctypes binding against its ``extern "C"`` declaration,
and the CPU path of the wrappers that launch a CUDA kernel."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.fused_elastic import fused_elastic as fe  # noqa: E402


def test_nvcc_command_targets_sm_90a_under_the_repo():
    source = cuda_build.source_path("fused_elastic")
    out = cuda_build.library_path("fused_elastic", source.read_bytes())
    cmd = cuda_build.nvcc_command("nvcc", source, out)
    joined = " ".join(cmd)
    for flag in ("-gencode arch=compute_90a,code=sm_90a", "-shared",
                 "-Xcompiler -fPIC", "-cudart shared", "-O3", "-std=c++17"):
        assert flag in joined
    assert "--use_fast_math" not in joined       # the FMA rounding is exact
    assert source.is_file()
    assert source.parent == cuda_build.CSRC_DIR
    assert cuda_build.CSRC_DIR.parts[-2:] == ("repro_torch", "csrc")
    assert out.parent == cuda_build.LIB_DIR
    assert out.parent.parts[-2:] == ("build", "cuda")
    assert re.fullmatch(r"fused_elastic-[0-9a-f]{16}\.so", out.name)
    assert cmd[cmd.index("-o") + 1] == str(out) and cmd[-1] == str(source)


def test_library_name_follows_the_source_bytes():
    source = cuda_build.source_path("fused_elastic").read_bytes()
    same = cuda_build.library_path("fused_elastic", source)
    assert same == cuda_build.library_path("fused_elastic", bytes(source))
    edited = cuda_build.library_path("fused_elastic", source + b"\n// edited\n")
    assert edited != same and edited.parent == same.parent


def test_load_library_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", tmp_path / "none")
    monkeypatch.setattr(cuda_build, "LIB_DIR", tmp_path / "build" / "cuda")
    cuda_build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.load_library("fused_elastic")
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.find_nvcc()
    finally:
        cuda_build.load_library.cache_clear()
    assert not (tmp_path / "build" / "cuda").exists() or not any(
        (tmp_path / "build" / "cuda").glob("*.so"))


def _extern_c(source: str) -> dict:
    """Name -> parameter count of every function defined inside the
    source's ``extern "C" { … }`` block."""
    block = source[source.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"^[\w\s\*]*?\b(\w+)\(([^)]*)\)\s*\{", block, re.M):
        params = [p for p in m.group(2).split(",") if p.strip()]
        found[m.group(1)] = len(params)
    return found


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_every_binding_matches_its_extern_c_declaration(name):
    declared = _extern_c(cuda_build.source_path(name).read_text())
    assert declared.get("cuda_error_string") == 1
    for fn, argtypes in cuda_build.SIGNATURES[name].items():
        assert fn in declared, f"{fn} is not declared extern \"C\" in {name}.cu"
        assert declared[fn] == len(argtypes), (fn, declared[fn], len(argtypes))


@pytest.mark.parametrize("side", ["client", "server"])
@pytest.mark.parametrize("pair", [(torch.float32, torch.float32),
                                  (torch.float32, torch.bfloat16),
                                  (torch.bfloat16, torch.float32),
                                  (torch.bfloat16, torch.bfloat16)])
def test_cpu_tensors_take_the_plain_version(side, pair):
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(4099, generator=gen).to(pair[0])
    c = torch.randn(4099, generator=gen).to(pair[1])
    alpha = torch.tensor(0.5 / 3)
    kernel = getattr(fe, f"elastic_{side}_flat")
    before = kernel.launches
    got = kernel(w, c, alpha)
    assert kernel.launches == before
    want = getattr(fe, f"elastic_{side}_flat_plain")(w, c, alpha)
    assert got.dtype == (c if side == "server" else w).dtype
    assert torch.equal(got, want)
