"""The encoder-decoder (whisper-base) and the VLM (paligemma-3b) on the
GSPMD path: trained through ``make_train_step(..., mesh)``, prefilled
through ``launch.serve.make_prefill_step(model, mesh)`` and decoded through
``make_serve_step(model, mesh)`` on DTensor state over 4 gloo ranks on the
CPU (one spawn, ``launch.mesh.spawn_ranks``; each case on its own
(data 2, model 2) layout of the world; the rank workers are in
``tests/_torch_gspmd_families.py``).

What the mesh meets here first: whisper's non-causal encoder stack, its
cross-attention over 64 encoder frames (k / v recomputed from the cache's
``enc`` at every decode token, ``enc`` laid out by ``cache_specs`` with
its batch on 'data' and d on 'model'), its LayerNorm biases and learned
positions (the serve step reads ``dec_pos`` at the cache's device index);
paligemma's ``image_embeds`` prefix concatenated onto the batch-sharded
text, the prefix-LM mask inside the chunked core, ``h[:, n_img:]`` before
the loss, gemma's embedding scale, the tied embedding as the unembedding,
and one KV head, which 'model' does not divide, so its cache is
sequence-sharded with 'data' 2.

Each case (reduced, f32, from the moved seed-0 params; whisper's cache
holds a nonzero encoder output set by hand, as the reference's serve
never fills it) is held to the port's one-process run within rtol 1e-5
(and 1e-5 of a leaf's scale): 3 momentum-SGD steps' losses, metrics and
state after steps 1 and 3; the prefill logits; a 16-token prompt and 8
greedy tokens — every step's logits, the tokens equal, the final cache,
and each cache leaf laid out as ``cache_specs`` says. The one-process
paths are held to ``jax.jit`` of the reference's step, ``forward`` and
``serve_step`` on bridged weights (rtol 1e-4, atol 1e-5, as
``tests/test_torch_encdec_vlm.py``). The specs themselves — params,
cache (``enc`` among them), batch and tokens — equal the reference's on
both meshes at both sizes, with no spawn.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_families as TF  # noqa: E402
import _torch_gspmd_families as G  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, get_config, reduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

NAMES = tuple(G.ENCDEC_VLM)
PATHS = ("train", "prefill", "decode")
JOBS = [(path, name) for name in NAMES for path in PATHS]


def _reference(name) -> dict:
    """The one-process paths on bridged weights beside the reference's."""
    cfg = reduced(get_config(name))
    tm = build_model(cfg)
    enc = G.enc_output(tm, G.DECODE_BATCH) if cfg.is_enc_dec else None
    return TF.mesh_paths_against_reference(
        name, G.batches_for(tm), TF.tokens(cfg, G.DECODE_BATCH, G.MAX_SEQ), enc=enc)


@pytest.fixture(scope="module")
def runs():
    """Every job on the 4 ranks, and meanwhile the one-process runs and
    the reference's."""
    return G.world_runs(JOBS, meanwhile=lambda: {n: _reference(n) for n in NAMES})


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", NAMES)
def test_path_on_mesh_equals_one_process(runs, name, path):
    ranks, one, _ = runs
    want = one[(path, name)]
    if path == "prefill":
        m = G.model(name)
        assert want["logits"].shape == (G.BATCH, G.SEQ, m.cfg.padded_vocab)
    for r in ranks[(path, name)]:
        G.hold(path, r, want)


class _Mesh:
    def __init__(self, shape, axes=G.DENSE_AXES):
        self.shape = dict(zip(axes, shape))


@pytest.mark.parametrize("name", NAMES)
def test_cache_keeps_its_cache_specs_layout(runs, name):
    """After the last decode step every cache leaf (whisper's ``enc``
    among them) is laid out as ``cache_specs`` says."""
    ranks, one, _ = runs
    mesh = _Mesh(G.CASES[name][1][0])
    specs = tserve.cache_specs(one[("decode", name)]["cache"], mesh)
    want = [tuple(str(p) for p in trules.placements(s, mesh))
            for s in tree_leaves(specs, trules.is_spec)]
    for r in ranks[("decode", name)]:
        assert tree_leaves(r["layout"], lambda x: isinstance(x, tuple)) == want


def test_whisper_enc_is_laid_out_batch_on_data_d_on_model(runs):
    ranks, one, _ = runs
    enc = one[("decode", "whisper-base")]["cache"]["enc"]
    assert int(torch.count_nonzero(enc)) == enc.numel()
    for r in ranks[("decode", "whisper-base")]:
        assert r["layout"]["enc"] == ("S(0)", "S(2)")
        assert torch.equal(r["cache"]["enc"], enc)


def test_paligemma_cache_is_sequence_sharded(runs):
    """One KV head: 'model' shards the cache's sequence dim, 'data' its
    batch."""
    ranks, _, _ = runs
    for r in ranks[("decode", "paligemma-3b")]:
        assert r["layout"]["k"] == r["layout"]["v"] == ("S(1)", "S(2)")


@pytest.mark.parametrize("name", NAMES)
def test_one_process_paths_equal_reference(runs, name):
    """The oracle above, on bridged weights, against ``jax.jit`` of the
    reference's per-leaf step (3 losses), ``forward`` and serve step (24
    tokens, whisper's cache holding the same nonzero ``enc``)."""
    ref = runs[2][name]
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
@pytest.mark.parametrize("name", NAMES)
def test_specs_equal_reference(name, shape, full):
    """``param_specs``, ``cache_specs`` (``enc`` among them), the train
    batch's specs (``audio_frames`` / ``image_embeds`` among them) and
    ``token_specs`` equal the reference's, path by path; every spec is
    placeable on the mesh."""
    TF.check_mesh_specs(name, _Mesh(shape), full)


def test_decode_shape_batch_of_the_reference_lays_out():
    """The reference's decode_32k batch of whisper: tokens on 'data'."""
    tm = build_model(get_config("whisper-base"))
    spec = tm.input_specs(INPUT_SHAPES["decode_32k"])["tokens"]
    assert tuple(tserve.token_specs(tuple(spec.shape), _Mesh((2, 2)))) == ("data", None)
