"""The sharded decode step, ``launch.serve.make_serve_step(model, mesh)``,
over gloo ranks on the CPU (one process each, ``launch.mesh.spawn_ranks``;
the rank workers are in ``tests/_torch_gspmd_families.py``): params laid
out by ``param_specs``, the cache by ``cache_specs``, the tokens by
``token_specs``.

Cases (reduced, f32; a 16-token teacher-forced prompt, then 8 greedy
tokens, batch 2, 24 cache slots):

- qwen2-moe-a2.7b and mixtral-8x7b (its 64-token window: a rolling
  buffer) on ('data', 'expert', 'tp') = (2, 2, 2);
- mamba2-130m and zamba2-1.2b on (data 2, model 2): the SSM states'
  heads and conv channels on 'model', in f32 (the SSM's bf16 decode
  drifts, ROADMAP's parity traps);
- qwen2-0.5b with its 2 KV heads on 'model' at (data 2, model 2), and at
  (data 1, model 4), where 'model' does not divide them and
  ``cache_specs`` shards the cache's sequence dim (6 slots a rank): each
  rank writes a token only into its own slots, and the softmax's max and
  sum and the value product all-reduce over 'model'.

Each is held to the port's one-process ``serve_step`` from the same moved
seed-0 params: every step's logits within rtol 1e-5 (and 1e-5 of their
scale), the greedy tokens equal, the final cache whole within the same
tolerance and each of its leaves laid out as ``cache_specs`` says. The
one-process decode of each arch is held to the reference's
``jax.jit(model.serve_step)`` on bridged weights (rtol 1e-4, atol 1e-5).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_families as TF  # noqa: E402
import _torch_gspmd_families as G  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b", "mamba2-130m", "zamba2-1.2b", "qwen2-0.5b")


def _reference_decode(arch) -> tuple:
    """The reference's and the port's one-process serve steps over the
    same 24 tokens from bridged weights: (port logits, reference
    logits)."""
    jm, tm, jp, tp = TF.bridged(arch)
    toks = TF.tokens(jm.cfg, G.DECODE_BATCH, G.MAX_SEQ)
    jl, tl, _, _ = TF.teacher_forced(jm, tm, jp, tp, toks, G.MAX_SEQ)
    return tl, jl


@pytest.fixture(scope="module")
def runs():
    """The three meshes' ranks spawned side by side, and meanwhile the
    one-process decodes and the reference's: ({case: [rank results]},
    {case: one-process result}, {arch: (port, reference) logits})."""
    groups = {}
    for case, (_, mesh) in G.DECODE.items():
        groups.setdefault(mesh, []).append(("decode", case))
    ranks, errors = {}, []

    def run(mesh, jobs):
        try:
            res = spawn_ranks(G.rank, mesh[0], mesh[1], backend="gloo",
                              device="cpu", args=(jobs,))
            for job in jobs:
                ranks[job[1]] = [r[job] for r in res]
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(m, j)) for m, j in groups.items()]
    for t in threads:
        t.start()
    torch.set_num_threads(1)
    try:
        one = {case: G.decode(None, case) for case in G.DECODE}
        ref = {arch: _reference_decode(arch) for arch in ARCHS}
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return ranks, one, ref


@pytest.mark.parametrize("case", list(G.DECODE))
def test_decode_on_mesh_equals_one_process(runs, case):
    ranks, one, _ = runs
    want = one[case]
    assert want["logits"].shape[0] == G.PROMPT + G.NEW
    for r in ranks[case]:
        G.hold("decode", r, want)


class _Mesh:
    def __init__(self, case):
        shape, axes = G.DECODE[case][1]
        self.shape = dict(zip(axes, shape))


@pytest.mark.parametrize("case", list(G.DECODE))
def test_cache_keeps_its_cache_specs_layout(runs, case):
    """After the last step every cache leaf is laid out as
    ``cache_specs`` says (the reference's out_shardings); the index is
    replicated."""
    ranks, one, _ = runs
    mesh = _Mesh(case)
    specs = tserve.cache_specs(one[case]["cache"], mesh)
    want = [tuple(str(p) for p in trules.placements(s, mesh))
            for s in tree_leaves(specs, trules.is_spec)]
    for r in ranks[case]:
        assert tree_leaves(r["layout"], lambda x: isinstance(x, tuple)) == want


def test_qwen2_cache_is_sharded_by_heads_or_by_sequence():
    """(2, 2) shards the 2 KV heads over 'model'; (1, 4) cannot, and
    shards the cache's sequence dim instead (layer, batch, seq)."""
    cache = G.model("qwen2-0.5b").init_cache(G.DECODE_BATCH, G.MAX_SEQ, "cpu")
    for case, spec in (("qwen2-0.5b-kv-heads", "P(None, 'data', None, 'model')"),
                       ("qwen2-0.5b-seq", "P(None, 'data', 'model')")):
        specs = tserve.cache_specs(cache, _Mesh(case))
        assert repr(specs["k"]) == repr(specs["v"]) == spec
        assert repr(specs["index"]) == "P()"


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_decode_equals_reference(runs, arch):
    """The one-process serve step on bridged weights against the
    reference's, every step of 24 tokens."""
    port, ref = runs[2][arch]
    assert len(port) == G.MAX_SEQ
    for t, (got, want) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"step {t}")


def test_serve_steps_default_to_the_card():
    """``make_serve_step`` defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.make_serve_step(G.model("qwen2-0.5b"))
