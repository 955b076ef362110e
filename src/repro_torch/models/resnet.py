"""Compact ResNet (He et al. 2015), the paper's model family (it trains
ResNet-50 on ImageNet 1K): the port of ``repro/models/resnet.py``, used by
``launch/hybrid_ps_mpi`` to train through the six modes of
``core/algorithms.run`` on synthetic image data.

The param tree and the batch keep the reference's layouts — HWIO conv
weights, NHWC images — so the FlatBuffer offsets and the bridge carry
across unchanged; only ``_conv`` permutes to PyTorch's OIHW / NCHW views
(the NHWC storage makes those views ``channels_last``). The convolutions
are cuDNN's (``F.conv2d``): the reference computes them in
``lax.conv_general_dilated``, outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.resnet50_cifar import ResNetConfig


def _conv_init(gen: torch.Generator, shape, device) -> torch.Tensor:
    """He-normal HWIO weights, drawn on the generator's device (so a seed
    gives the same weights on every device) and moved to ``device``."""
    fan_in = shape[0] * shape[1] * shape[2]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(math.sqrt(2.0 / fan_in)).to(device)


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``ceil(n / stride)``
    outputs, the extra row on the high side (a 3x3 stride-2 conv on an
    even input pads (0, 1), which ``F.conv2d(padding=1)`` would not)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` by HWIO ``w`` with ``"SAME"`` padding -> NHWC. Symmetric
    padding goes to the conv itself; an uneven one is padded explicitly."""
    ph = _same_pad(x.shape[1], w.shape[0], stride)
    pw = _same_pad(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    pad = (ph[0], pw[0])
    if ph[0] != ph[1] or pw[0] != pw[1]:
        xc, pad = F.pad(xc, pw + ph), (0, 0)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _gn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        groups: int = 8) -> torch.Tensor:
    """GroupNorm over ``min(groups, C)`` groups of contiguous channels, in
    f32 with the biased variance and eps 1e-5 (batch-independent: async
    workers see different batches)."""
    g = min(groups, x.shape[-1])
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), g, scale.float(),
                     bias.float(), eps=1e-5)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _block_plan(cfg: ResNetConfig):
    """Static (stride, c_in, c_out) per block — kept out of the param tree."""
    plan, c_in = [], cfg.width
    for stage, n in enumerate(cfg.stage_sizes):
        c_out = cfg.width * (2 ** stage)
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            plan.append((stride, c_in, c_out))
            c_in = c_out
    return plan, c_in


def init_resnet(gen: torch.Generator, cfg: ResNetConfig, device="cuda") -> dict:
    """``{"stem", "stem_s", "stem_b", "blocks": [...], "head", "head_b"}``,
    each block ``c1 s1 b1 c2 s2 b2`` and a 1x1 ``proj`` where the shape
    changes."""
    w = cfg.width
    ones = lambda n: torch.ones((n,), device=device)
    zeros = lambda n: torch.zeros((n,), device=device)
    p = {"stem": _conv_init(gen, (3, 3, 3, w), device),
         "stem_s": ones(w), "stem_b": zeros(w)}
    plan, c_final = _block_plan(cfg)
    blocks = []
    for stride, c_in, c_out in plan:
        blk = {
            "c1": _conv_init(gen, (3, 3, c_in, c_out), device),
            "s1": ones(c_out), "b1": zeros(c_out),
            "c2": _conv_init(gen, (3, 3, c_out, c_out), device),
            "s2": ones(c_out), "b2": zeros(c_out),
        }
        if stride != 1 or c_in != c_out:
            blk["proj"] = _conv_init(gen, (1, 1, c_in, c_out), device)
        blocks.append(blk)
    p["blocks"] = blocks
    head = torch.randn((c_final, cfg.num_classes), generator=gen, device=gen.device)
    p["head"] = head.mul_(0.01).to(device)
    p["head_b"] = zeros(cfg.num_classes)
    return p


def resnet_apply(p: dict, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    x = F.relu(_gn(_conv(images, p["stem"]), p["stem_s"], p["stem_b"]))
    plan, _ = _block_plan(cfg)
    for blk, (stride, _, _) in zip(p["blocks"], plan):
        h = F.relu(_gn(_conv(x, blk["c1"], stride), blk["s1"], blk["b1"]))
        h = _gn(_conv(h, blk["c2"]), blk["s2"], blk["b2"])
        sc = _conv(x, blk["proj"], stride) if "proj" in blk else x
        x = F.relu(h + sc)
    x = torch.mean(x, dim=(1, 2))
    return x @ p["head"] + p["head_b"]


def resnet_loss(p: dict, batch: dict, cfg: ResNetConfig
                ) -> tuple[torch.Tensor, dict]:
    logits = resnet_apply(p, batch["images"], cfg)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"acc": acc}
