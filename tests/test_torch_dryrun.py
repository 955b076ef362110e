"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's (``repro/launch/dryrun.py``) and against what it traces.

The fake worlds run in subprocesses (``tests/_torch_dryrun.py``, which
imports no JAX), all started together once for the module, so each world
pays its imports once:

- (a) ``skip_reason`` equals the reference's over all 10 × 4 combos;
- (b) the result dict's keys, its ``extrapolation``'s keys, and the kind
  names of its ``collective_schedule`` are the reference's (read from the
  reference's source: its own dry run compiles for minutes);
- (c) every leaf's local ``meta`` shard of the train state and the decode
  cache, on the pod, multi-pod and MoE layouts, for all ten
  architectures, has the shape the reference's ``state_specs`` /
  ``cache_specs`` give: each named dim divided by its axes' sizes;
- (d) the prefills of chip_smoke's phase 15 c) (each case's config,
  depth, bf16, batch and mesh, on a fake world of 4), converted to staged
  bytes, equal ``staged_prediction``'s prefill bytes, which the card
  measured (the gather of the last 8 logits left out of both);
- (e) the extrapolated FLOPs and wire bytes equal the full-depth trace for
  a dense decoder and for the hybrid (at whole groups of its period);
  the bytes do not, and fall short of it;
- (f) one dense layer's traced FLOPs equal the closed form;
- (g) the reference's two CLI tests (``tests/test_multidevice.py``):
  mamba2-130m decode_32k on the pod exits 0 and prints ``dominant=``;
  qwen2-0.5b long_500k exits 0 without it;
- ``--link-bw`` prices the collective term (without it the term is None).

Every hold is exact.
"""
import ast
import inspect
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import hierarchy as jhier  # noqa: E402
from repro.launch import serve as jserve, train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import analysis as tanalysis, dryrun as tdryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "_torch_dryrun.py"
sys.path.insert(0, str(ROOT / "tests"))
import _torch_dryrun as H  # noqa: E402
import _torch_gspmd_families as GF  # noqa: E402

jsgd = __import__("importlib").import_module("repro.optim.sgd")

LAYOUTS = {
    "pod": {"data": 16, "model": 16},
    "multipod": {"pod": 2, "data": 16, "model": 16},
    "moe": {"data": 16, "expert": 8, "tp": 2},
}
JOB_OF = {"pod": "shapes256", "moe": "shapes256", "multipod": "shapes512"}
#: a link of 1 kB/s: slow enough that the collective term dominates
LINK_BW = 1e3
CLI = {"decode": ["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh", "pod"],
       "skip": ["--arch", "qwen2-0.5b", "--shape", "long_500k", "--mesh", "pod"],
       "link": ["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh", "pod",
                "--no-extrapolate", "--link-bw", str(LINK_BW)]}
TIMEOUT = 300


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _run(args: list) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable] + args, capture_output=True, text=True,
                          cwd=ROOT, env=_env(), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every fake world of the module, started together: the helper's jobs
    -> their JSON, the CLI runs -> (completed process, its --out JSON)."""
    out = tmp_path_factory.mktemp("dryrun")
    cli_args = {k: ["-m", "repro_torch.launch.dryrun", *a, "--out", str(out / f"{k}.json")]
                for k, a in CLI.items()}
    with ThreadPoolExecutor(len(H.JOBS) + len(CLI)) as ex:
        jobs = {j: ex.submit(_run, [str(HELPER), j]) for j in H.JOBS}
        cli = {k: ex.submit(_run, a) for k, a in cli_args.items()}
        res = {}
        for j, fut in jobs.items():
            r = fut.result()
            assert r.returncode == 0, (j, r.stderr[-3000:])
            res[j] = json.loads(r.stdout.strip().splitlines()[-1])
        for k, fut in cli.items():
            r = fut.result()
            path = out / f"{k}.json"
            res[k] = (r, json.loads(path.read_text()) if path.exists() else None)
    return res


# -- (a) the skip rule -----------------------------------------------------------

def _reference_dryrun():
    """``repro.launch.dryrun``, imported without letting its XLA_FLAGS
    write reach this process's later subprocesses: JAX's devices are made
    first (the write then changes nothing here), the old value restored
    after."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_skip_reason_equals_reference(arch):
    jdryrun = _reference_dryrun()
    for name in jbase.INPUT_SHAPES:
        assert tdryrun.skip_reason(tbase.get_config(arch), tbase.INPUT_SHAPES[name]) == \
            jdryrun.skip_reason(jbase.get_config(arch), jbase.INPUT_SHAPES[name]), name
    assert tdryrun._reduced_depths(tbase.get_config(arch)) == \
        jdryrun._reduced_depths(jbase.get_config(arch))


# -- (b) the result's keys ---------------------------------------------------------

def _dict_keys(src: str, name: str) -> set:
    """The string keys of the dict literals assigned to ``name`` in
    ``src``."""
    keys = set()
    for node in ast.walk(ast.parse(textwrap.dedent(src))):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
    return keys


def test_result_keys_are_the_reference_s(runs):
    jdryrun = _reference_dryrun()
    src = inspect.getsource(jdryrun.lower_one)
    r, res = runs["decode"]
    assert r.returncode == 0, r.stderr[-3000:]
    (got,) = res
    assert set(got) == _dict_keys(src, "result")
    assert set(got["extrapolation"]) == _dict_keys(src, "extra")
    assert set(got["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    kinds = set(re.search(r"\((all-[^)]*)\)", jdryrun.analysis._COLL_RE.pattern)
                .group(1).split("|"))
    assert got["collective_schedule"] and set(got["collective_schedule"]) <= kinds
    assert set(tanalysis.COLLECTIVE_KINDS) == kinds
    assert got["compile_s"] == 0.0 and got["chips"] == 256
    assert got["roofline"]["collective_s"] is None


# -- (c) every leaf's local shard --------------------------------------------------

def _jkey(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _expected_local(jtree, jspecs, axes: dict) -> dict:
    """{key path: the shape each dim divided by its spec entry's axes}."""
    shapes = {_jkey(p): tuple(x.shape)
              for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    specs = {_jkey(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JP))[0]}
    out = {}
    for k, shape in shapes.items():
        spec = tuple(specs[k]) + (None,) * (len(shape) - len(specs[k]))
        local = []
        for dim, entry in zip(shape, spec):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            ways = math.prod(axes[a] for a in names)
            assert dim % ways == 0, (k, shape, spec)
            local.append(dim // ways)
        out[k] = local
    return out


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_local_shards_are_the_reference_specs(runs, arch):
    jm = jbuild(jbase.get_config(arch))
    cache = jax.eval_shape(lambda: jm.init_cache(
        jbase.INPUT_SHAPES["decode_32k"].global_batch,
        jbase.INPUT_SHAPES["decode_32k"].seq_len))
    for layout, axes in LAYOUTS.items():
        mesh = SimpleNamespace(shape=dict(axes))
        C = axes.get("pod", 1)
        jsync = jhier.SyncConfig(mode="mpi_esgd" if C > 1 else "mpi_sgd", num_clients=C,
                                 fused_update=False)
        state = jtrain.make_train_state(jm, jsgd.sgd(0.1, momentum=0.9), jsync,
                                        abstract=True)
        got = runs[JOB_OF[layout]][layout][arch]
        assert got["state"] == _expected_local(
            state, jtrain.state_specs(state, mesh, jsync), axes), layout
        assert got["cache"] == _expected_local(
            cache, jserve.cache_specs(cache, mesh), axes), layout


# -- (d) the prefill's staged bytes -------------------------------------------------

@pytest.mark.parametrize("arch", list(H.PREFILL_CASES))
def test_prefill_staged_bytes_equal_staged_prediction(runs, arch):
    depth, shape, prefill = H.PREFILL_CASES[arch]
    want = GF.staged_prediction(arch, depth, shape, None, prefill,
                                prefill_tail=0)["prefill"]
    assert runs["world4"]["prefill"][arch] == {k: v for k, v in want.items() if v}


# -- (e) the extrapolation -----------------------------------------------------------

@pytest.mark.parametrize("arch", list(H.EXTRAP_CASES))
def test_extrapolation_equals_the_full_trace(runs, arch):
    rec = runs["extrap256"][arch]
    full, extra = rec["full"], rec["extrapolation"]
    assert extra["depths"] == list(tdryrun._reduced_depths(tbase.get_config(arch)))
    assert extra["flops"] == full["flops"] > 0
    assert extra["wire"] == full["wire"] > 0
    # each layer's stacked-leaf gradient writes the whole stack: bytes grow
    # faster than linearly in depth
    assert extra["bytes"] < full["bytes"]


# -- (f) one dense layer's FLOPs ---------------------------------------------------

def test_dense_layer_flops_equal_the_closed_form(runs):
    """One qwen2.5-3b layer's prefill on (data 2, model 2): per rank, the
    q / k / v / o projections and the three MLP products on its column or
    row shard, and the two attention products over its KV group's heads
    (one 512-token block, scores over the whole square)."""
    arch, (data, model), (B, S) = H.LAYER_CASE
    cfg = tbase.get_config(arch)
    d, hd, H_, KV, ff = (cfg.d_model, cfg.resolved_head_dim, cfg.num_heads,
                         cfg.num_kv_heads, cfg.d_ff)
    rows = B // data
    proj = 2 * rows * S * d * (2 * H_ * hd + 2 * KV * hd + 3 * ff) // model
    attn = 2 * 2 * rows * (H_ // model) * S * S * hd
    assert runs["world4"]["layer_flops"] == proj + attn


# -- (g) the reference's CLI tests ----------------------------------------------------

def test_cli_single_combo_pod(runs):
    r, res = runs["decode"]
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "dominant=" in r.stdout
    assert res[0]["arch"] == "mamba2-130m" and res[0]["chips"] == 256


def test_cli_skip_rule(runs):
    r, res = runs["skip"]
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dominant=" not in r.stdout
    assert res[0]["skipped"].startswith("full-attention arch")


def test_link_rate_prices_the_collective_term(runs):
    """With ``--link-bw`` the collective term is a rank's wire bytes over
    the link rate, and ``dominant`` is taken over all three terms."""
    r, res = runs["link"]
    assert r.returncode == 0, r.stderr[-2000:]
    roof = res[0]["roofline"]
    unpriced = runs["decode"][1][0]["roofline"]
    assert roof["wire_bytes"] == unpriced["wire_bytes"] > 0
    assert math.isclose(roof["collective_s"], roof["wire_bytes"] / roof["chips"] / LINK_BW,
                        rel_tol=1e-12)
    terms = {k: roof[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert roof["dominant"] == max(terms, key=terms.get) == "collective"
    assert re.search(r"dominant=collective .* x=[0-9.]+ms", r.stdout)
