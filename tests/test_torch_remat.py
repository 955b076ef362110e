"""Rematerialisation in the port, where the reference applies
``jax.checkpoint``: each layer body of the training stacks when
``cfg.remat`` is set (``models/transformer``), each chunk of the chunked
loss (``models/model._sequence_xent``) and each attention query chunk
(``models/attention.multi_head_attention``) always.

- every one of the ten architectures, reduced, on one sequence of two
  loss chunks (2 × ``XENT_CHUNK`` text tokens): the checkpointed regions
  counted as the forward opens them (the ``cfg.remat`` sites only with
  remat on), the loss and every gradient leaf ``torch.equal`` with remat
  on, off, and with no checkpoint at all, and fewer tensors saved for the
  backward at each step down;
- ``multi_head_attention`` with 64-token chunks on a 256-token causal
  sequence, with and without a sliding window: several query chunks
  checkpointed, output and gradients ``==`` the same chunks without the
  checkpoint, and within f32 tolerance of the reference's gradients;
- the backward-overlap stages (one ``autograd.grad`` a stage): the packed
  staged gradient ``==`` with remat on and off;
- the GSPMD step at (data 2, model 2), sequence-sharded between blocks,
  with remat on, on two loss chunks: within rtol 1e-5 of the one-process
  step with remat off (the tolerance of tests/test_torch_gspmd.py).

"No checkpoint at all" swaps the ``remat`` helper that the three model
modules call for a plain call.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_remat as R  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core.comm import CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel_mod  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.model import XENT_CHUNK, build_model  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten  # noqa: E402

torch.set_num_threads(2)

#: the modules that call ``layers.remat``
REMAT_USERS = (ttransformer, tattn, tmodel_mod)
Q_CHUNK = 1024  # multi_head_attention's default, which every caller takes


def _plain(fn, *args, enabled=True):
    return fn(*args)


@pytest.fixture
def no_checkpoint(monkeypatch):
    """Swap every checkpointed region for a plain call."""
    def off():
        for mod in REMAT_USERS:
            monkeypatch.setattr(mod, "remat", _plain)
    return off


@pytest.fixture
def regions(monkeypatch):
    """Count the regions ``layers.remat`` checkpoints while counting is on."""
    box = {"n": 0, "on": False}
    real = tlayers.checkpoint

    def counted(*args, **kw):
        box["n"] += box["on"]
        return real(*args, **kw)

    monkeypatch.setattr(tlayers, "checkpoint", counted)
    return box


def _batch(cfg, seed=0) -> dict:
    """One sequence of 2 × XENT_CHUNK text tokens (+ the VLM's image
    prefix, whisper's frames)."""
    rng = np.random.default_rng(seed)
    S = 2 * XENT_CHUNK
    toks = rng.integers(0, cfg.vocab_size, (1, S + 1))
    b = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
         "labels": torch.from_numpy(toks[:, 1:]).int()}
    if cfg.num_image_tokens:
        b["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (1, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_enc_dec:
        b["audio_frames"] = torch.from_numpy(rng.standard_normal(
            (1, cfg.enc_seq_len, cfg.d_model)).astype(np.float32))
    return b


def _loss_and_grads(cfg, params, batch, regions=None):
    """Loss, gradient leaves, tensors saved for the backward, and (with
    ``regions``) the regions the forward checkpointed."""
    model = build_model(cfg)
    leaves, treedef = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    if regions is not None:
        regions.update(n=0, on=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss_fn(tree_unflatten(treedef, leaves), batch)
    n_regions = None
    if regions is not None:
        n_regions, regions["on"] = regions["n"], False
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, saved[0], n_regions


def _sites(cfg) -> tuple[int, int]:
    """(layer bodies under ``cfg.remat``, always-checkpointed chunks) of one
    forward on ``_batch``: two loss chunks, and ceil(Sq / 1024) query
    chunks per attention call."""
    L, text = cfg.num_layers, 2 * XENT_CHUNK
    nq = math.ceil((text + cfg.num_image_tokens) / Q_CHUNK)
    if cfg.arch_type == "ssm":
        layers, attn = L, 0
    elif cfg.arch_type == "hybrid":   # the shared block: chunks, no layer wrap
        layers, attn = L, (L // cfg.attn_period) * nq
    elif cfg.is_enc_dec:              # encoder self; decoder self + cross
        layers = cfg.enc_layers + L
        attn = cfg.enc_layers * math.ceil(cfg.enc_seq_len / Q_CHUNK) + 2 * L * nq
    else:
        layers, attn = L, L * nq
    return layers, attn + 2


@pytest.mark.parametrize("name", ARCH_IDS)
def test_remat_sites_bit_equal_and_fewer_saved(name, regions, no_checkpoint):
    cfg = reduced(get_config(name))
    params = build_model(cfg).init(device="cpu", seed=0)
    batch = _batch(cfg)
    on = _loss_and_grads(dataclasses.replace(cfg, remat=True), params, batch, regions)
    off = _loss_and_grads(dataclasses.replace(cfg, remat=False), params, batch, regions)
    layers, chunks = _sites(cfg)
    assert (on[3], off[3]) == (layers + chunks, chunks)
    no_checkpoint()
    none = _loss_and_grads(dataclasses.replace(cfg, remat=False), params, batch)
    for got in (off, none):
        assert torch.equal(got[0], on[0])
        assert len(got[1]) == len(on[1])
        for a, b in zip(got[1], on[1]):
            assert torch.equal(a, b)
    assert on[2] < off[2] < none[2], (on[2], off[2], none[2])


# ---------------------------------------------------------------------------
# attention: several query chunks checkpointed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 96])
def test_attention_query_chunks(window, regions, no_checkpoint):
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, sliding_window=window)
    jspec, tspec = jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)
    jp = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.key(0), 32, jspec, jnp.float32))
    x = (np.random.default_rng(0).standard_normal((2, 256, 32)) * 0.5).astype(np.float32)
    ct = np.random.default_rng(1).standard_normal((2, 256, 32)).astype(np.float32)

    def port(count=None):
        tp = params_from_numpy(jp)
        leaves, treedef = tree_flatten(tp)
        leaves = [a.requires_grad_(True) for a in leaves]
        xt = torch.from_numpy(x).requires_grad_(True)
        if count is not None:
            count.update(n=0, on=True)
        out = tattn.multi_head_attention(tree_unflatten(treedef, leaves), xt, tspec,
                                         q_chunk=64, kv_chunk=64)
        if count is not None:
            count["on"] = False
        grads = torch.autograd.grad(out, leaves + [xt], torch.from_numpy(ct))
        return out.detach(), grads

    out, grads = port(regions)
    assert regions["n"] == 4          # 256 / 64 query chunks
    no_checkpoint()
    out_p, grads_p = port()
    assert torch.equal(out, out_p)
    for a, b in zip(grads, grads_p):
        assert torch.equal(a, b)

    def ref(p, xx):
        y = jattn.multi_head_attention(p, xx, jspec, q_chunk=64, kv_chunk=64)
        return jnp.sum(y * ct)

    jg = jax.jit(jax.grad(ref, argnums=(0, 1)))(jax.tree.map(jnp.asarray, jp),
                                                jnp.asarray(x))
    want = jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the backward-overlap stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,S", [("qwen2-0.5b", 2 * XENT_CHUNK),
                                    ("qwen2-moe-a2.7b", 64)])
def test_overlap_stage_grads_equal_with_remat_on_and_off(name, S):
    sync = SyncConfig(mode="mpi_sgd", policy=CollectivePolicy(
        method="ring", num_rings=1, overlap=True, overlap_buckets=4))
    toks = np.random.default_rng(0).integers(0, 1024, (2, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
             "labels": torch.from_numpy(toks[:, 1:]).int()}
    out = {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(reduced(get_config(name)),
                                                remat=remat))
        stages, sched = ttrain.overlap_schedule(model, sync, 1)
        gfn = ttrain.make_overlap_grad_fn(model, stages, sched, tcomm.LOCAL)
        out[remat] = gfn(model.init(device="cpu", seed=1), batch)
    assert stages.num_stages == 4
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][2], out[False][2])


# ---------------------------------------------------------------------------
# the GSPMD step
# ---------------------------------------------------------------------------

def test_gspmd_step_with_remat():
    ranks = spawn_ranks(R.run, (2, 2), ("data", "model"), backend="gloo",
                        device="cpu", args=(True,))
    torch.set_num_threads(1)
    want = R.run(None, remat=False)
    torch.set_num_threads(2)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        got_l, want_l = tree_leaves(r["params"]), tree_leaves(want["params"])
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * scale)
