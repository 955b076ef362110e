"""Policy autotuner: rank the collective-policy space with the cost model
(``repro/launch/autotune.py``).

Enumerate the ``CollectivePolicy`` grid, prune every candidate the one
``CollectivePolicy.validate()`` rejects (its message becomes the prune
reason: invalid points are ranked out, not crashed on), score the
survivors with ``core.cost_model`` (per-device wire bytes of the
gradient + param legs, modeled step wall time) and pick the fastest.
``launch/train.py --policy auto`` and the launcher run this at start-up.

Scoring conventions (matching the fused sharded step the drivers run):

  ring-family   reduce-scatter + allgather, wire-scaled β
                (``grad_leg_bytes`` + ``param_leg_bytes``)
  psum          the same ring pattern at full precision
  tree          2·ceil(log2 p) full-buffer hops
  per_leaf      ring bytes + one collective launch per leaf (α each)
  overlap       ``overlapped_step_time``: the hidden reduce-scatter
                fraction rides behind backward compute

The network defaults to ``cost_model.testbed()``, the paper's own
InfiniBand ConnectX-4 cluster (12.5 GB/s a link): no link between two
H100s has been measured, so the ranking prices the paper's network, not
this port's hardware. The compute rates come from ``launch.analysis``'s
keywords (H100 data-sheet defaults); pass ``net`` and the rates to rank
at other ones.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import cost_model
from repro_torch.core.collectives import METHODS, RING_METHODS
from repro_torch.core.comm import CollectivePolicy
from repro_torch.launch.analysis import HBM_BW, PEAK_FLOPS, train_model_flops

#: deterministic tie-break order among equal-time, equal-byte candidates:
#: the plain single ring first, then the other ring variants, then the
#: library-native and reference methods
_METHOD_PREF = ("ring", "multi_ring", "scatter_gather", "psum", "tree",
                "per_leaf")

#: wire preference on exact ties (bytes already order the wires)
_WIRE_PREF = (None, "bf16", "int8")

#: byte-bucketing grid point (4 MiB); modeled as the monolithic leg,
#: enumerated so the overlap ⇒ no-byte-bucketing guard prunes a candidate
_BUCKET_CHOICES = (None, 4 << 20)


@dataclass(frozen=True)
class ScoredPolicy:
    """One valid candidate with its cost-model score."""

    policy: CollectivePolicy
    bytes_per_step: float    # per-device wire bytes, grad + param legs
    step_time_s: float       # modeled wall time of one step
    overlap_fraction: float  # structural hidden fraction (0 = none)

    def to_dict(self) -> dict:
        return {"policy": self.policy.to_dict(),
                "bytes_per_step": self.bytes_per_step,
                "step_time_s": self.step_time_s,
                "overlap_fraction": self.overlap_fraction}


@dataclass(frozen=True)
class PrunedPolicy:
    """One grid point ``CollectivePolicy.validate()`` rejected."""

    policy: CollectivePolicy
    reason: str

    def to_dict(self) -> dict:
        return {"policy": self.policy.to_dict(), "reason": self.reason}


@dataclass(frozen=True)
class AutotuneResult:
    chosen: ScoredPolicy
    ranked: tuple            # every valid candidate, best first
    pruned: tuple            # every invalid grid point with its guard
    nbytes: float            # f32 gradient payload the scores assume
    p: int                   # ring size (devices per client)
    compute_s: float         # per-step compute the overlap legs hide in

    def to_dict(self) -> dict:
        return {
            "chosen": self.chosen.to_dict(),
            "ranked": [s.to_dict() for s in self.ranked],
            "pruned": [s.to_dict() for s in self.pruned],
            "nbytes": self.nbytes, "p": self.p, "compute_s": self.compute_s,
        }


def enumerate_policies() -> list[CollectivePolicy]:
    """The full candidate grid, valid and invalid alike: every method ×
    ring count (multi_ring explores 2 and 4) × wire dtype × overlap ×
    byte-bucketing point. ``autotune`` prunes with ``validate()``."""
    grid = []
    for method in METHODS:
        ring_counts = (2, 4) if method == "multi_ring" else (1,)
        for num_rings in ring_counts:
            for wire in (None, "bf16", "int8"):
                for overlap in (False, True):
                    for bucket in _BUCKET_CHOICES:
                        grid.append(CollectivePolicy(
                            method=method, num_rings=num_rings,
                            bucket_bytes=bucket, wire_dtype=wire,
                            overlap=overlap))
    return grid


def policy_bytes_per_step(policy: CollectivePolicy, nbytes: float,
                          p: int) -> float:
    """Per-device wire bytes of one synchronized step under ``policy``:
    ring-family methods run the wire-scaled reduce-scatter + allgather
    halves (``cost_model.grad_leg_bytes`` / ``param_leg_bytes``); psum
    and per_leaf move the same ring bytes at full precision; tree pays
    2·ceil(log2 p) full-buffer hops."""
    if p <= 1:
        return 0.0
    if policy.method == "tree":
        return 2 * math.ceil(math.log2(p)) * nbytes
    wire = policy.wire if policy.method in RING_METHODS else None
    return (cost_model.grad_leg_bytes(nbytes, p, wire)
            + cost_model.param_leg_bytes(nbytes, p, wire))


def score_policy(policy: CollectivePolicy, *, nbytes: float, p: int,
                 compute_s: float = 0.0,
                 net: Optional[cost_model.NetParams] = None,
                 num_leaves: int = 64) -> ScoredPolicy:
    """Cost-model score of one VALID policy (callers prune first);
    ``net`` defaults to ``cost_model.testbed()``."""
    net = net or cost_model.testbed()
    wire = policy.wire if policy.method in RING_METHODS else None
    frac = 0.0
    if policy.overlap:
        bb = [nbytes / policy.overlap_buckets] * policy.overlap_buckets
        time_s = cost_model.overlapped_step_time(compute_s, bb, p, net, wire)
        frac = cost_model.overlap_fraction(bb, p)
    elif policy.method == "per_leaf":
        # one collective launch per leaf on top of the ring wire bytes
        time_s = (compute_s + cost_model.ring_allreduce_time(nbytes, p, net)
                  + num_leaves * max(p - 1, 0) * net.alpha)
    else:
        time_s = compute_s + cost_model.allreduce_time(
            nbytes, p, net, policy.method, policy.num_rings, wire)
    return ScoredPolicy(policy=policy,
                        bytes_per_step=policy_bytes_per_step(
                            policy, nbytes, p),
                        step_time_s=time_s, overlap_fraction=frac)


def _rank_key(s: ScoredPolicy):
    pol = s.policy
    return (s.step_time_s, s.bytes_per_step,
            _METHOD_PREF.index(pol.method), pol.num_rings,
            _WIRE_PREF.index(pol.wire), pol.overlap,
            pol.bucket_bytes or 0)


def autotune(*, nbytes: float, p: int, compute_s: float = 0.0,
             net: Optional[cost_model.NetParams] = None,
             num_leaves: int = 64) -> AutotuneResult:
    """Enumerate → prune → score → rank the policy space.

    ``nbytes`` is the packed f32 gradient payload (the FlatBuffer size),
    ``p`` the devices one client syncs over, ``compute_s`` the per-step
    compute time. Returns every valid candidate ranked fastest first
    (ties broken by bytes, then method preference), plus every pruned
    grid point with the ``validate()`` message that rejected it.
    """
    if p < 1:
        raise ValueError(f"autotune needs p >= 1 devices, got {p}")
    if nbytes <= 0:
        raise ValueError(f"autotune needs a positive payload, got {nbytes}")
    scored, pruned = [], []
    for pol in enumerate_policies():
        try:
            pol.validate(where="autotune")
        except ValueError as e:
            pruned.append(PrunedPolicy(policy=pol, reason=str(e)))
            continue
        scored.append(score_policy(pol, nbytes=nbytes, p=p,
                                   compute_s=compute_s, net=net,
                                   num_leaves=num_leaves))
    ranked = tuple(sorted(scored, key=_rank_key))
    return AutotuneResult(chosen=ranked[0], ranked=ranked,
                          pruned=tuple(pruned), nbytes=nbytes, p=p,
                          compute_s=compute_s)


def fused_step_compute_s(nbytes: float, *, hbm_bw: float = HBM_BW) -> float:
    """Per-step compute estimate where only the payload is known: the
    fused update's HBM roofline — ~5 full passes over the packed buffer
    (grad read, param read + write, momentum read + write) at
    ``hbm_bw``."""
    return 5.0 * nbytes / hbm_bw


def compute_s_for_model(cfg, tokens_per_step: int, p: int, *,
                        peak_flops: float = PEAK_FLOPS) -> float:
    """Per-device per-step compute time of a model config on the
    roofline: ``6·N·D`` training FLOPs over ``p`` devices at
    ``peak_flops``."""
    flops = train_model_flops(cfg.param_count(), cfg.active_param_count(),
                              tokens_per_step)
    return flops / (p * peak_flops)


def autotune_for_model(cfg, *, p: int, tokens_per_step: int,
                       net: Optional[cost_model.NetParams] = None,
                       peak_flops: float = PEAK_FLOPS) -> AutotuneResult:
    """``autotune`` for a model config: payload = f32 param bytes,
    compute from the 6·N·D roofline at ``p`` devices."""
    nbytes = 4.0 * cfg.param_count()
    return autotune(nbytes=nbytes, p=p,
                    compute_s=compute_s_for_model(cfg, tokens_per_step, p,
                                                  peak_flops=peak_flops),
                    net=net)


def format_table(result: AutotuneResult, top: int = 5) -> str:
    """Markdown ranking table of the ``top`` candidates."""
    lines = [
        "| # | method | rings | wire | overlap | bucket | bytes/step"
        " | step time |",
        "|---|--------|-------|------|---------|--------|-----------:"
        "|----------:|",
    ]
    for i, s in enumerate(result.ranked[:top], 1):
        pol = s.policy
        bucket = (f"{pol.bucket_bytes >> 20} MiB" if pol.bucket_bytes
                  else "—")
        lines.append(
            f"| {i} | {pol.method} | {pol.num_rings} "
            f"| {pol.wire_dtype or 'f32'} "
            f"| {'yes' if pol.overlap else 'no'} | {bucket} "
            f"| {s.bytes_per_step:,.0f} | {s.step_time_s * 1e6:,.1f} µs |")
    return "\n".join(lines)
