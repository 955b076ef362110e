"""The dense decoders qwen2.5-3b, qwen3-4b and phi3-medium-14b on the GSPMD
path: trained through ``make_train_step(..., mesh)``, prefilled through
``launch.serve.make_prefill_step(model, mesh)`` and decoded through
``make_serve_step(model, mesh)`` on DTensor state over 4 gloo ranks on the
CPU (one spawn, ``launch.mesh.spawn_ranks``; each case on its own layout
of the world; the rank workers are in ``tests/_torch_gspmd_families.py``).

Cases (reduced, f32: 4 q heads, head dim 64): qwen2.5-3b (2 KV heads,
q / k / v biases under the ("heads",) spec, tied embeddings) on
(data 2, model 2) and on (data 1, model 4) — there 'model' cuts each KV
head's ``bk`` / ``bv`` columns in two, the biases are added before
``fit_heads`` gathers k / v and the q heads ahead of their split into KV
groups, and the cache is sequence-sharded; qwen3-4b (qk-norm: ``q_norm``
/ ``k_norm`` of (head_dim,), replicated, on head-sharded q / k) and
phi3-medium-14b (a plain GQA decoder: separate ``wq`` / ``wk`` / ``wv``,
no fused ``wqkv`` leaf) on (data 2, model 2).

Each is held to the port's one-process run from the moved seed-0 params
within rtol 1e-5 (and 1e-5 of a leaf's scale): 3 momentum-SGD steps'
losses, metrics and state after steps 1 and 3; the prefill logits; a
16-token prompt and 8 greedy tokens — every step's logits, the tokens
equal, the final cache, each cache leaf laid out as ``cache_specs``
says. The one-process paths are held to ``jax.jit`` of the reference's
step, ``forward`` and ``serve_step`` on bridged weights (rtol 1e-4, atol
1e-5, as ``tests/test_torch_serve.py``). The specs — params, cache,
batch and tokens — equal the reference's on both meshes at both sizes,
with no spawn; at full width phi3's 10 KV heads and qwen2.5's 2 leave a
4-way 'model' the cache's sequence dim.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_families as TF  # noqa: E402
import _torch_gspmd_families as G  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CASES = tuple(G.DENSE)
ARCHS = tuple(dict.fromkeys(G.arch_of(c) for c in CASES))
PATHS = ("train", "prefill", "decode")
JOBS = [(path, case) for case in CASES for path in PATHS]


def _reference(arch) -> dict:
    """The one-process paths on bridged weights beside the reference's."""
    cfg = reduced(get_config(arch))
    return TF.mesh_paths_against_reference(
        arch, G.batches_for(build_model(cfg)), TF.tokens(cfg, G.DECODE_BATCH, G.MAX_SEQ))


@pytest.fixture(scope="module")
def runs():
    """Every job on the 4 ranks, and meanwhile the one-process runs and
    the reference's."""
    return G.world_runs(JOBS, meanwhile=lambda: {a: _reference(a) for a in ARCHS})


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", CASES)
def test_path_on_mesh_equals_one_process(runs, case, path):
    ranks, one, _ = runs
    want = one[(path, case)]
    if path == "prefill":
        m = G.model(G.arch_of(case))
        assert want["logits"].shape == (G.BATCH, G.SEQ, m.cfg.padded_vocab)
    for r in ranks[(path, case)]:
        G.hold(path, r, want)


class _Mesh:
    def __init__(self, shape, axes=G.DENSE_AXES):
        self.shape = dict(zip(axes, shape))


@pytest.mark.parametrize("case", CASES)
def test_cache_keeps_its_cache_specs_layout(runs, case):
    ranks, one, _ = runs
    mesh = _Mesh(G.CASES[case][1][0])
    specs = tserve.cache_specs(one[("decode", case)]["cache"], mesh)
    want = [tuple(str(p) for p in trules.placements(s, mesh))
            for s in tree_leaves(specs, trules.is_spec)]
    for r in ranks[("decode", case)]:
        assert tree_leaves(r["layout"], lambda x: isinstance(x, tuple)) == want


def test_qwen25_cache_is_sharded_by_heads_or_by_sequence(runs):
    """(2, 2) shards the 2 KV heads over 'model'; (1, 4) the cache's
    sequence dim (6 slots a rank). The batch is on 'data' in both."""
    ranks, _, _ = runs
    for case, layout in (("qwen2.5-3b", ("S(1)", "S(3)")),
                         ("qwen2.5-3b-seq", ("S(1)", "S(2)"))):
        for r in ranks[("decode", case)]:
            assert r["layout"]["k"] == r["layout"]["v"] == layout


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_paths_equal_reference(runs, arch):
    """The oracle above, on bridged weights, against ``jax.jit`` of the
    reference's per-leaf step (3 losses), ``forward`` and serve step (24
    tokens)."""
    ref = runs[2][arch]
    port, want = ref["losses"]
    assert len(port) == G.STEPS
    np.testing.assert_allclose(port, want, rtol=1e-4)
    got, want = ref["logits"]
    np.testing.assert_allclose(got, want, rtol=TF.RTOL, atol=TF.ATOL)
    port, want = ref["serve"]
    assert len(port) == G.MAX_SEQ
    for t, (a, b) in enumerate(zip(port, want)):
        np.testing.assert_allclose(a, b, rtol=TF.RTOL, atol=TF.ATOL, err_msg=f"step {t}")


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, shape, full):
    TF.check_mesh_specs(arch, _Mesh(shape), full)


def test_kv_bias_columns_are_cut_inside_a_head():
    """On a 4-way 'model' qwen2.5-3b's 2 KV heads' ``bk`` / ``bv`` are
    sharded by columns (a quarter of 2·head_dim each: half a head) and
    its cache by sequence; qwen3-4b's qk-norm scales are replicated;
    phi3's full-width 10 KV heads leave the cache to the sequence too."""
    for full in (False, True):
        cfg = get_config("qwen2.5-3b")
        cfg = cfg if full else reduced(cfg)
        ps, cs = TF.check_mesh_specs("qwen2.5-3b", _Mesh((1, 4)), full)
        attn = ps["layers"]["attn"]
        assert tuple(attn["bk"]) == tuple(attn["bv"]) == (None, "model")
        assert 2 * cfg.resolved_head_dim // 4 < cfg.resolved_head_dim
        assert tuple(cs["k"]) == (None, "data", "model")
    ps, _ = TF.check_mesh_specs("qwen3-4b", _Mesh((2, 2)), True)
    assert tuple(ps["layers"]["attn"]["q_norm"]) == tuple(ps["layers"]["attn"]["k_norm"]) == ()
    ps, cs = TF.check_mesh_specs("phi3-medium-14b", _Mesh((1, 4)), True)
    assert "wqkv" not in ps["layers"]["attn"]
    assert tuple(ps["layers"]["attn"]["wk"]) == (None, None, "model")
    assert tuple(cs["k"]) == (None, "data", "model")
