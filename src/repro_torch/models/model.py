"""Model API: ``build_model(cfg)`` returns a ``Model`` whose functions are

  init(device, seed=0)      -> params (nested dict, stacked layer leaves)
  loss_fn(params, batch)    -> (loss, metrics)                [train_4k]
  forward(params, batch)    -> logits                         [prefill_32k]
  init_cache(batch, max_seq, device) -> KV cache              [decode shapes]
  serve_step(params, cache, tokens)  -> (logits, cache)       [one new token]
  input_specs(shape)        -> ``meta`` tensors standing in for the batch
  overlap_stages(num_buckets) -> OverlapStages (loss_fn as a stage chain
                               for the backward-overlapped step)

The port has every family of ``repro/models/model.py``: the decoder
(dense, MoE and the VLM, ``_build_decoder``; the VLM prepends stub image
embeddings as a bidirectional prefix and scales its embeddings by
``sqrt(d_model)``, as gemma does), the pure SSM (``_build_ssm``, mamba2),
the hybrid (``_build_hybrid``, zamba2) and the encoder-decoder
(``_build_enc_dec``, whisper, with stub audio-frame embeddings).
``init(device="meta")`` gives shape-only params, the
counterpart of ``jax.eval_shape(model.init, ...)``; ``input_specs`` is the
counterpart of the reference's ``ShapeDtypeStruct`` batches.

``serve_step`` consumes the cache it is given, as a donated buffer: the
new token's k / v (and the SSM's ``h`` / ``conv`` states) are written into
its storage in place, and the cache it returns holds the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.layers import layer_norm, remat, rms_norm
from repro_torch.models.transformer import (
    apply_dec_stack,
    apply_enc_stack,
    apply_hybrid,
    apply_mamba_stack,
    apply_stack,
    decode_dec_stack,
    decode_hybrid,
    decode_mamba_stack,
    decode_stack,
    init_dec_layer,
    init_enc_layer,
    init_hybrid,
    init_hybrid_cache,
    init_mamba_cache,
    init_mamba_stack,
    init_stack,
    init_stack_cache,
)
from repro_torch.sharding.rules import embedding_lookup, local_rows, rows_like, unshard_dim
from repro_torch.tree import tree_map

XENT_CHUNK = 512
MAX_WHISPER_POSITIONS = 32768


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    forward: Callable
    init_cache: Callable
    serve_step: Callable
    input_specs: Callable
    # backward-overlap staging: overlap_stages(num_buckets) -> OverlapStages
    # splitting loss_fn into a chain of stages whose param subtrees become
    # the reduce-scatter schedule buckets. None = no staged form.
    overlap_stages: "Callable | None" = None


@dataclass(frozen=True)
class OverlapStages:
    """``loss_fn`` as a chain of stages for backward-overlapped sync
    (``repro/models/model.py``).

    ``stage(params, ndim=0)`` splits the param tree into per-stage
    subtrees (tuple, forward order); ``fns[0](p0, batch)`` produces the
    first carry and ``fns[s](ps, carry, batch)`` the next, with the LAST
    stage returning ``(loss, metrics)`` — composing all stages replays
    ``loss_fn``'s ops in its order. ``unstage(parts, ndim=0)`` inverts
    ``stage``. ``ndim`` is the number of leading stacked dims (emulated
    devices) the leaves carry ahead of the layer dim. A leaf used by
    several stages (the tied embedding: token lookup in stage 0, the
    logits product in the head) is a stage param of ONLY its earliest
    stage and its VALUE rides the carry to later stages, so each leaf
    lives in exactly one schedule bucket and its full gradient is
    complete when its owning stage's backward runs.
    """

    stage: Callable
    fns: tuple
    unstage: Callable

    @property
    def num_stages(self) -> int:
        return len(self.fns)


def _generator(device, seed: int) -> torch.Generator | None:
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _normal(gen, shape, std: float, dtype, device, *, cast_first: bool = False
            ) -> torch.Tensor:
    """N(0, std²) drawn in f32; scaled before the cast to ``dtype``, or
    after it with ``cast_first`` (the reference's embedding tables). On
    the ``meta`` device nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.to(dtype) * std if cast_first else (w * std).to(dtype)


def _embed_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"embedding": _normal(gen, (v, d), 0.02, dtype, device, cast_first=True),
         "final_norm": torch.zeros((d,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(gen, (d, v), d ** -0.5, dtype, device)
    return p


def _logits(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].T
    else:
        logits = x @ p["lm_head"]
    pad = cfg.padded_vocab - cfg.vocab_size
    if pad:  # mask padded vocab ids (a Python scalar: no host-to-device copy)
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits, -1e30)
    return logits


def _lookup(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not ``emb[tokens]``: on the CPU the indexing backward
    # accumulates repeated tokens with parallel atomic adds (run-to-run
    # different sums); embedding's backward sums each row in token order.
    # On DTensors (the GSPMD path) the vocab-parallel lookup, its rows laid
    # out as the batch (sharding.rules.embedding_lookup)
    return embedding_lookup(p["embedding"], tokens)


def _embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = _lookup(p, tokens)
    if cfg.arch_type == "vlm":
        # gemma's embedding scale, rounded to the activation dtype first
        # as the reference's ``jnp.asarray(d ** 0.5, x.dtype)`` is
        scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        x = x * scale
    return x


def _with_image(x: torch.Tensor, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The VLM's stub image embeddings prepended to the text embeddings."""
    if not cfg.num_image_tokens:
        return x
    return torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)


def _xent_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # vocab-sharded logits (a DTensor) are gathered over the vocab first:
    # torch.gather on the sharded dim leaves a pending form that fails
    logits = unshard_dim(logits, -1).float()
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit of each rank's own rows: DTensor's gather backward
    # scatters into zeros of the whole global chunk on every rank
    gold = torch.gather(local_rows(logits), -1, local_rows(labels).long()[..., None])
    return torch.sum(lse - rows_like(gold[..., 0], logits))


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _xent_sum(logits, labels) / labels.numel()


def _chunk_xent(p: dict, hc: torch.Tensor, lc: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    return _xent_sum(_logits(p, hc, cfg), lc)


def _sequence_xent(p: dict, h: torch.Tensor, labels: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Next-token xent from hidden states, in ``XENT_CHUNK``-long sequence
    chunks when the sequence is a multiple longer than one chunk. Each
    chunk is rematerialised (always, as the reference's scan body is), so
    its logits, logsumexp and gold are recomputed in the backward and one
    chunk's f32 logits are alive at a time, not all of them."""
    B, S, _ = h.shape
    if S % XENT_CHUNK or S <= XENT_CHUNK:
        return _xent(_logits(p, h, cfg), labels)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, S, XENT_CHUNK):
        hc, lc = h[:, lo:lo + XENT_CHUNK], labels[:, lo:lo + XENT_CHUNK]
        total = total + remat(_chunk_xent, p, hc, lc, cfg)
    return total / (B * S)


def build_model(cfg: ModelConfig) -> Model:
    build = {"dense": _build_decoder, "vlm": _build_decoder,
             "moe": _build_decoder, "ssm": _build_ssm, "hybrid": _build_hybrid,
             "audio": _build_enc_dec}[cfg.arch_type]
    return build(cfg, cfg.torch_dtype)


def _cache_device(device):
    from repro_torch.launch.train import resolve_device

    return resolve_device(device)


def _build_decoder(cfg: ModelConfig, dtype) -> Model:
    n_img = cfg.num_image_tokens

    def init(device="cuda", seed: int = 0) -> dict:
        gen = _generator(device, seed)
        p = _embed_init(gen, cfg, dtype, device)
        p["layers"] = init_stack(gen, cfg, dtype, device)
        return p

    def backbone(p, batch):
        x = _with_image(_embed(p, batch["tokens"], cfg), batch, cfg)
        x, aux = apply_stack(p["layers"], x, cfg, prefix_len=n_img)
        return rms_norm(x, p["final_norm"], cfg.norm_eps), aux

    def forward(p, batch):
        h, _ = backbone(p, batch)
        return _logits(p, h, cfg)

    def loss_fn(p, batch):
        h, aux = backbone(p, batch)
        if n_img:
            h = h[:, n_img:]
        xent = _sequence_xent(p, h, batch["labels"], cfg)
        return xent + aux, {"xent": xent, "aux": aux}

    def init_cache(batch: int, max_seq: int, device="cuda") -> dict:
        return init_stack_cache(batch, max_seq, cfg, dtype, _cache_device(device))

    @torch.no_grad()
    def serve_step(p, cache, tokens):
        x = _embed(p, tokens, cfg)  # (B, 1, d)
        x, cache = decode_stack(p["layers"], x, cache, cfg)
        x = rms_norm(x, p["final_norm"], cfg.norm_eps)
        return _logits(p, x, cfg), cache

    return Model(cfg, init, loss_fn, forward, init_cache, serve_step,
                 lambda shape: _decoder_specs(cfg, shape, dtype),
                 overlap_stages=_decoder_overlap_stages(cfg, loss_fn))


def _build_ssm(cfg: ModelConfig, dtype) -> Model:
    """Pure SSM (mamba2): the Mamba2 stack under ``params["layers"]``."""
    return _build_recurrent(
        cfg, dtype,
        init_body=lambda gen, device: {
            "layers": init_mamba_stack(gen, cfg, dtype, device)},
        backbone=lambda p, x: apply_mamba_stack(p["layers"], x, cfg),
        init_cache=lambda batch, max_seq, device: init_mamba_cache(
            batch, cfg, dtype, device),
        decode=lambda p, x, cache: (
            decode_mamba_stack(p["layers"], x, cache, cfg), cache))


def _build_hybrid(cfg: ModelConfig, dtype) -> Model:
    """Hybrid (zamba2): the Mamba2 stack with the shared attention block
    every ``attn_period`` layers."""
    return _build_recurrent(
        cfg, dtype,
        init_body=lambda gen, device: init_hybrid(gen, cfg, dtype, device),
        backbone=lambda p, x: apply_hybrid(p, x, cfg)[0],
        init_cache=lambda batch, max_seq, device: init_hybrid_cache(
            batch, max_seq, cfg, dtype, device),
        decode=lambda p, x, cache: decode_hybrid(p, x, cache, cfg))


def _build_recurrent(cfg: ModelConfig, dtype, *, init_body, backbone,
                     init_cache, decode) -> Model:
    """The SSM and hybrid families around their backbone: the embedding,
    the final norm and the head, a loss with no aux term and no staged
    form (``overlap_stages`` None, as in the reference)."""

    def init(device="cuda", seed: int = 0) -> dict:
        gen = _generator(device, seed)
        p = _embed_init(gen, cfg, dtype, device)
        p.update(init_body(gen, device))
        return p

    def hidden(p, tokens):
        x = backbone(p, _embed(p, tokens, cfg))
        return rms_norm(x, p["final_norm"], cfg.norm_eps)

    def forward(p, batch):
        return _logits(p, hidden(p, batch["tokens"]), cfg)

    def loss_fn(p, batch):
        loss = _sequence_xent(p, hidden(p, batch["tokens"]), batch["labels"], cfg)
        return loss, {"xent": loss}

    def cache_fn(batch: int, max_seq: int, device="cuda") -> dict:
        return init_cache(batch, max_seq, _cache_device(device))

    @torch.no_grad()
    def serve_step(p, cache, tokens):
        x, cache = decode(p, _embed(p, tokens, cfg), cache)
        x = rms_norm(x, p["final_norm"], cfg.norm_eps)
        return _logits(p, x, cfg), cache

    return Model(cfg, init, loss_fn, forward, cache_fn, serve_step,
                 lambda shape: _decoder_specs(cfg, shape, dtype))


def _meta(dims, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(dims, dtype=dtype, device="meta")


def _decoder_specs(cfg: ModelConfig, shape: InputShape, dtype) -> dict:
    """The batch of ``shape`` as ``meta`` tensors (shape and dtype only);
    the VLM's sequence is its image prefix and then the text."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1))}
    n_img = cfg.num_image_tokens
    text = S - n_img
    batch = {"tokens": _meta((B, text))}
    if n_img:
        batch["image_embeds"] = _meta((B, n_img, cfg.d_model), dtype)
    if shape.kind == "train":
        batch["labels"] = _meta((B, text))
    return batch


# --------------------------------------------------------------------------
# encoder-decoder (whisper): conv/mel frontend stubbed as frame embeddings
# --------------------------------------------------------------------------

def _build_enc_dec(cfg: ModelConfig, dtype) -> Model:
    """Whisper: learned absolute positions (``enc_pos`` / ``dec_pos``),
    LayerNorm blocks, no overlap stages (as the reference). The serve
    cache is ``{"self": <the stacked KV cache>, "enc": (B, enc_seq_len,
    d)}``; ``init_cache`` makes ``enc`` zeros and nothing fills it, so
    serving cross-attends to a zero encoder output, as the reference's
    does."""
    d = cfg.d_model

    def init(device="cuda", seed: int = 0) -> dict:
        gen = _generator(device, seed)
        p = _embed_init(gen, cfg, dtype, device)
        p["final_norm_b"] = torch.zeros((d,), dtype=dtype, device=device)
        p["final_norm"] = torch.ones((d,), dtype=dtype, device=device)
        p["enc_pos"] = {"pos_embedding": _normal(
            gen, (cfg.enc_seq_len, d), 0.02, dtype, device, cast_first=True)}
        p["dec_pos"] = {"pos_embedding": _normal(
            gen, (MAX_WHISPER_POSITIONS, d), 0.02, dtype, device, cast_first=True)}
        p["encoder"] = init_enc_layer(gen, cfg, dtype, device, cfg.enc_layers)
        p["decoder"] = init_dec_layer(gen, cfg, dtype, device, cfg.num_layers)
        p["enc_final_norm"] = torch.ones((d,), dtype=dtype, device=device)
        p["enc_final_norm_b"] = torch.zeros((d,), dtype=dtype, device=device)
        return p

    def encode(p, frames):
        x = frames.to(dtype) + p["enc_pos"]["pos_embedding"][:frames.shape[1]]
        x = apply_enc_stack(p["encoder"], x, cfg)
        return layer_norm(x, p["enc_final_norm"], p["enc_final_norm_b"])

    def decode_full(p, enc, tokens):
        x = _lookup(p, tokens) + p["dec_pos"]["pos_embedding"][:tokens.shape[1]]
        x = apply_dec_stack(p["decoder"], x, enc, cfg)
        return layer_norm(x, p["final_norm"], p["final_norm_b"])

    def forward(p, batch):
        enc = encode(p, batch["audio_frames"])
        return _logits(p, decode_full(p, enc, batch["tokens"]), cfg)

    def loss_fn(p, batch):
        h = decode_full(p, encode(p, batch["audio_frames"]), batch["tokens"])
        loss = _sequence_xent(p, h, batch["labels"], cfg)
        return loss, {"xent": loss}

    def init_cache(batch: int, max_seq: int, device="cuda") -> dict:
        device = _cache_device(device)
        return {"self": init_stack_cache(batch, max_seq, cfg, dtype, device),
                "enc": torch.zeros((batch, cfg.enc_seq_len, d), dtype=dtype,
                                   device=device)}

    @torch.no_grad()
    def serve_step(p, cache, tokens):
        # the position row by a device index: no host sync
        at = cache["self"]["index"][:1].long()
        x = _lookup(p, tokens) + p["dec_pos"]["pos_embedding"].index_select(0, at)
        x, new_self = decode_dec_stack(p["decoder"], x, cache["enc"],
                                       cache["self"], cfg)
        x = layer_norm(x, p["final_norm"], p["final_norm_b"])
        return _logits(p, x, cfg), {"self": new_self, "enc": cache["enc"]}

    def input_specs(shape: InputShape) -> dict:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": _meta((B, 1))}
        batch = {"tokens": _meta((B, S)),
                 "audio_frames": _meta((B, cfg.enc_seq_len, d), dtype)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S))
        return batch

    return Model(cfg, init, loss_fn, forward, init_cache, serve_step, input_specs)


def _decoder_overlap_stages(cfg: ModelConfig, loss_fn) -> Callable:
    """Stage factory for the decoder family (dense / moe / vlm; the MoE's
    aux loss rides the carry, the VLM's image embeddings enter with the
    token embeddings and its prefix length reaches every layer slice):
    [embed] + k layer slices +
    [head], where k = num_buckets - 2 clamped to [1, num_layers] (ceil
    split: the first ``num_layers % k`` slices take one layer more). Each
    stage replays exactly the ops ``loss_fn`` runs over its span, the
    chunked cross-entropy included, so the composed chain gives the
    monolithic loss and, stage by stage, its gradient bits. With tied
    embeddings the embedding is stage 0's param and its VALUE rides the
    carry to the head's logits product."""
    n_img = cfg.num_image_tokens

    def factory(num_buckets: int) -> OverlapStages:
        if num_buckets <= 1:
            # degenerate single-bucket schedule: the whole loss is one
            # stage, the one reduce-scatter leg simply trails backward
            return OverlapStages(stage=lambda p, ndim=0: (p,),
                                 fns=(lambda p0, batch: loss_fn(p0, batch),),
                                 unstage=lambda parts, ndim=0: parts[0])
        k = min(cfg.num_layers, max(1, int(num_buckets) - 2))
        base, rem = divmod(cfg.num_layers, k)
        slices, lo = [], 0
        for i in range(k):
            hi = lo + base + (1 if i < rem else 0)
            slices.append((lo, hi))
            lo = hi

        def stage(p, ndim=0):
            head = {"final_norm": p["final_norm"]}
            if not cfg.tie_embeddings:
                head["lm_head"] = p["lm_head"]
            return (({"embedding": p["embedding"]},)
                    + tuple(tree_map(lambda a, lo=lo, hi=hi:
                                     a.narrow(ndim, lo, hi - lo), p["layers"])
                            for lo, hi in slices)
                    + (head,))

        def unstage(parts, ndim=0):
            layers = parts[1:-1]
            p = {"embedding": parts[0]["embedding"],
                 "layers": (layers[0] if len(layers) == 1 else tree_map(
                     lambda *xs: torch.cat(xs, ndim), *layers)),
                 "final_norm": parts[-1]["final_norm"]}
            if not cfg.tie_embeddings:
                p["lm_head"] = parts[-1]["lm_head"]
            return p

        def embed_fn(p0, batch):
            x = _with_image(_embed(p0, batch["tokens"], cfg), batch, cfg)
            carry = {"x": x,
                     "aux": torch.zeros((), dtype=torch.float32, device=x.device)}
            if cfg.tie_embeddings:
                carry["emb"] = p0["embedding"]
            return carry

        def layer_fn(ps, carry, batch):
            h, a = apply_stack(ps, carry["x"], cfg, prefix_len=n_img)
            out = dict(carry)
            out["x"] = h
            out["aux"] = carry["aux"] + a
            return out

        def head_fn(ph, carry, batch):
            h = rms_norm(carry["x"], ph["final_norm"], cfg.norm_eps)
            if n_img:
                h = h[:, n_img:]
            pl = ({"embedding": carry["emb"]} if cfg.tie_embeddings
                  else {"lm_head": ph["lm_head"]})
            xent = _sequence_xent(pl, h, batch["labels"], cfg)
            return xent + carry["aux"], {"xent": xent, "aux": carry["aux"]}

        fns = (embed_fn,) + (layer_fn,) * k + (head_fn,)
        return OverlapStages(stage=stage, fns=fns, unstage=unstage)

    return factory
