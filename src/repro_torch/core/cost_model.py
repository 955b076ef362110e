"""α-β-γ communication cost model (``repro/core/cost_model.py``).

Bucket allreduce cost (Patarasuk & Yuan):  (p−1)α + 2·(p−1)/p·nβ + (p−1)/p·nγ
Multi-ring overlaps the γ (reduction) term with the β (transfer) term.
PS push/pull: a server's ingress link is shared by every concurrent pusher
(the network hot-spot of the paper's §2.3).

Ported: the wire-byte functions the emulated collectives are held to
(``core.collectives.WireMeter`` counts each hop's bytes), and the time
functions the six-mode simulation (``core.algorithms``) charges to its
simulated clock, with the byte and time accounting of a membership
change (``core.membership.reshard_optstate``, the shard driver's kills
and joins), and Fig. 12's epoch time (``epoch_time``). The one network preset is ``testbed()``, the paper's
InfiniBand ConnectX-4 cluster: it prices the simulated clock of the
paper's experiments and describes no hardware this port runs on. The
reference's second preset, a TPU's interconnect, is not carried over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class NetParams:
    alpha: float   # per-step latency (s)
    beta: float    # seconds per byte (link bandwidth⁻¹)
    gamma: float   # seconds per byte of local reduction


def testbed() -> NetParams:
    # the paper's IB CX-4 ~ 12.5 GB/s; host reduction ~30 GB/s
    return NetParams(alpha=5e-6, beta=1 / 12.5e9, gamma=1 / 30e9)


#: f32 -> wire byte ratio per wire dtype. int8 counts the codes (1 byte
#: per value) plus one f32 scale per WIRE_BLOCK = 128 bucket, matching
#: ``kernels.quant_bucket.wire_encode`` (the per-hop codec: a CUDA kernel
#: on the card, plain PyTorch on the CPU): (1 + 4/128)/4 = 0.2578125.
WIRE_RATIO = {
    None: 1.0,
    "f32": 1.0,
    "bf16": 0.5,
    "int8": (1 + 4 / 128) / 4,
}


def wire_ratio(wire_dtype: "str | None" = None) -> float:
    try:
        return WIRE_RATIO[wire_dtype]
    except KeyError:
        raise ValueError(
            f"wire_dtype must be one of {tuple(WIRE_RATIO)}, "
            f"got {wire_dtype!r}") from None


def wire_bytes(nbytes: float, wire_dtype: "str | None" = None) -> float:
    """f32 payload bytes -> bytes that actually cross the wire."""
    return nbytes * wire_ratio(wire_dtype)


def grad_leg_bytes(nbytes: float, p: int,
                   wire_dtype: "str | None" = None) -> float:
    """Per-device gradient-leg wire bytes of the sharded fused step: the
    ring reduce-scatter's (p−1)/p·n, scaled by the wire dtype."""
    if p <= 1:
        return 0.0
    return (p - 1) / p * wire_bytes(nbytes, wire_dtype)


def param_leg_bytes(nbytes: float, p: int,
                    wire_dtype: "str | None" = None) -> float:
    """Per-device param-allgather wire bytes (the second half)."""
    return grad_leg_bytes(nbytes, p, wire_dtype)


def elastic_leg_bytes(nbytes: float, p: int,
                      wire_dtype: "str | None" = None) -> float:
    """Per-device wire bytes of one sharded elastic exchange: the packed
    diff reduce-scatter + the center-shard allgather."""
    return 2 * grad_leg_bytes(nbytes, p, wire_dtype)


def ps_push_bytes(nbytes: float, wire_dtype: "str | None" = None) -> float:
    """PS-leg wire bytes of one push (the KVStore's compressed form)."""
    return wire_bytes(nbytes, wire_dtype)


def ps_wire_nbytes(n_values: int, wire_dtype: "str | None" = None) -> int:
    """EXACT PS-leg payload bytes of one push of ``n_values`` f32 values:

      f32   4n
      bf16  2n
      int8  n_pad + n_pad/128 * 4   (codes + one f32 scale per
                                     WIRE_BLOCK = 128 bucket, n padded
                                     up to whole buckets)
    """
    if wire_dtype in (None, "f32"):
        return 4 * n_values
    if wire_dtype == "bf16":
        return 2 * n_values
    if wire_dtype == "int8":
        from repro_torch.kernels.quant_bucket.quant_bucket import WIRE_BLOCK

        n_pad = -(-n_values // WIRE_BLOCK) * WIRE_BLOCK
        return n_pad + (n_pad // WIRE_BLOCK) * 4
    raise ValueError(f"wire_dtype must be None/f32/bf16/int8, "
                     f"got {wire_dtype!r}")


def reshard_leg_bytes(state_nbytes: float, p_old: int,
                      survivors: "int | None" = None,
                      wire_dtype: "str | None" = None) -> float:
    """Per-survivor wire bytes of re-laying-out 1/p_old-sharded state
    after a membership change: an allgather among the ``s`` survivors of
    their old shards — each receives the other s−1 shards of
    ``state_nbytes / p_old`` bytes. This is EXACTLY the ``moved_bytes``
    core/membership.py's ``reshard_optstate`` reports."""
    if p_old <= 1:
        return 0.0
    s = p_old if survivors is None else int(survivors)
    if s <= 1:
        return 0.0
    return (s - 1) * wire_bytes(state_nbytes / p_old, wire_dtype)


def resplit_time(p_new: int, net: NetParams) -> float:
    """Communicator re-split (MPI_Comm_split over the survivor group):
    an agreement round — ceil(log2(p_new)) latency-bound hops, no
    payload to speak of."""
    import math

    if p_new <= 1:
        return net.alpha
    return math.ceil(math.log2(p_new)) * net.alpha


def reconfig_time(state_nbytes: float, p_old: int, p_new: int,
                  net: NetParams, survivors: "int | None" = None,
                  wire_dtype: "str | None" = None) -> float:
    """Total recovery overhead of one membership change: the re-split
    agreement plus the survivor allgather realizing the new state
    layout (per-survivor bytes × β; the shards move in parallel)."""
    moved = reshard_leg_bytes(state_nbytes, p_old, survivors, wire_dtype)
    return resplit_time(p_new, net) + moved * net.beta


def restore_leg_bytes(n_values: int) -> int:
    """EXACT payload bytes of one parked-state restore leg: a respawned
    worker's ``get_state`` pull of ``n_values`` f32 values. Resume must
    be bit-identical, so state parking bypasses the wire codec (always
    4 bytes/value, no bf16/int8 option)."""
    return 4 * int(n_values)


def join_reshard_bytes(state_nbytes: float, p_old: int,
                       survivors: "int | None" = None,
                       wire_dtype: "str | None" = None) -> float:
    """Per-survivor wire bytes of admitting a joiner into
    1/p_old-sharded optimizer state: a grow is a reshard in which EVERY
    old shard survives — reconstruct from the s = p_old shards, then
    re-slice at the grown count. This is exactly the ``moved_bytes``
    ``membership.reshard_optstate`` reports for the join."""
    return reshard_leg_bytes(state_nbytes, p_old, survivors, wire_dtype)


def recovery_time(restore_nbytes: float, respawn_delay: float,
                  p_old: int, p_new: int, net: NetParams,
                  state_nbytes: float = 0.0,
                  survivors: "int | None" = None,
                  wire_dtype: "str | None" = None) -> float:
    """Wall-clock overhead of one crash recovery: the supervisor's
    respawn gap, the respawn's state-restore pull (exact-f32 bytes ×
    β), and — when sharded state must re-lay-out (a join/eviction, or
    any nonzero ``state_nbytes``) — the re-split agreement plus the
    survivor allgather (``reconfig_time``)."""
    t = float(respawn_delay) + restore_nbytes * net.beta
    if p_old != p_new or state_nbytes:
        t += reconfig_time(state_nbytes, p_old, p_new, net,
                           survivors=survivors, wire_dtype=wire_dtype)
    return t


def reduce_scatter_time(nbytes: float, p: int, net: NetParams,
                        wire_dtype: "str | None" = None) -> float:
    """One ring reduce-scatter leg: the allreduce's first half — (p−1)
    latency hops, (p−1)/p·n transfer (wire-scaled) and reduction."""
    if p <= 1:
        return 0.0
    return (
        (p - 1) * net.alpha
        + (p - 1) / p * wire_bytes(nbytes, wire_dtype) * net.beta
        + (p - 1) / p * nbytes * net.gamma
    )


def allgather_time(nbytes: float, p: int, net: NetParams,
                   wire_dtype: "str | None" = None) -> float:
    """One ring allgather leg: the allreduce's second half (no γ)."""
    if p <= 1:
        return 0.0
    return (
        (p - 1) * net.alpha
        + (p - 1) / p * wire_bytes(nbytes, wire_dtype) * net.beta
    )


def overlap_fraction(bucket_bytes: "list[float] | tuple", p: int) -> float:
    """Structural fraction of the gradient reduce-scatter's wire bytes
    issued while backward compute remains: bucket 0 (the embedding stage,
    differentiated last) is the one leg with nothing left to hide behind,
    so ``1 − bucket_bytes[0] / sum(bucket_bytes)``; 0.0 for a single
    bucket or p ≤ 1."""
    total = sum(bucket_bytes)
    if p <= 1 or len(bucket_bytes) <= 1 or total <= 0:
        return 0.0
    return 1.0 - bucket_bytes[0] / total


def overlapped_step_time(compute_time: float,
                         bucket_bytes: "list[float] | tuple", p: int,
                         net: NetParams,
                         wire_dtype: "str | None" = None) -> float:
    """Modeled wall time of one backward-overlapped step: the hidden
    ``overlap_fraction`` of the reduce-scatter rides behind backward
    compute (bounded by the compute itself); the exposed remainder, the
    trailing allgather and the extra per-bucket ring latencies pay in
    full."""
    nbytes = sum(bucket_bytes)
    rs = reduce_scatter_time(nbytes, p, net, wire_dtype)
    ag = allgather_time(nbytes, p, net, wire_dtype)
    extra_alpha = max(len(bucket_bytes) - 1, 0) * max(p - 1, 0) * net.alpha
    hidden = min(overlap_fraction(bucket_bytes, p) * rs, compute_time)
    return compute_time + (rs - hidden) + ag + extra_alpha


def ring_allreduce_time(nbytes: float, p: int, net: NetParams,
                        wire_dtype: "str | None" = None) -> float:
    """β (transfer) pays the wire-dtype ratio; γ (local reduction) stays
    full-precision — hops dequantize before accumulating."""
    if p <= 1:
        return 0.0
    return (
        (p - 1) * net.alpha
        + 2 * (p - 1) / p * wire_bytes(nbytes, wire_dtype) * net.beta
        + (p - 1) / p * nbytes * net.gamma
    )


def multi_ring_allreduce_time(nbytes: float, p: int, net: NetParams,
                              num_rings: int = 2,
                              wire_dtype: "str | None" = None) -> float:
    """γ of ring i overlaps β of ring i+1 → pay max(β, γ) instead of β+γ
    on the steady-state term (plus one non-overlapped γ pipeline fill)."""
    if p <= 1:
        return 0.0
    beta_term = 2 * (p - 1) / p * wire_bytes(nbytes, wire_dtype) * net.beta
    gamma_term = (p - 1) / p * nbytes * net.gamma
    fill = gamma_term / max(num_rings, 1)
    return (p - 1) * net.alpha * num_rings + max(beta_term, gamma_term) + fill


def tree_allreduce_time(nbytes: float, p: int, net: NetParams) -> float:
    """Binomial reduce + broadcast: 2·log2(p) full-buffer hops."""
    if p <= 1:
        return 0.0
    steps = 2 * math.ceil(math.log2(p))
    return steps * (net.alpha + nbytes * net.beta) + nbytes * net.gamma * math.log2(p)


def ps_pushpull_time(nbytes: float, num_pushers: int, num_servers: int,
                     net: NetParams,
                     wire_dtype: "str | None" = None) -> float:
    """Server ingress shared by every concurrent pusher + egress for
    pulls; each server holds 1/num_servers of the keys. A low-precision
    wire shrinks ingress and egress; the server reduces dequantized
    values, so γ is unscaled."""
    per_server = nbytes / max(num_servers, 1)
    on_wire = per_server * wire_ratio(wire_dtype)
    ingress = on_wire * num_pushers * net.beta  # serialized hot-spot
    egress = on_wire * num_pushers * net.beta
    reduce_cost = per_server * num_pushers * net.gamma
    return 2 * net.alpha + ingress + egress + reduce_cost


def allreduce_time(nbytes: float, p: int, net: NetParams, method: str,
                   num_rings: int = 2,
                   wire_dtype: "str | None" = None) -> float:
    return {
        "ring": lambda: ring_allreduce_time(nbytes, p, net, wire_dtype),
        "multi_ring": lambda: multi_ring_allreduce_time(
            nbytes, p, net, num_rings, wire_dtype),
        "scatter_gather": lambda: ring_allreduce_time(
            nbytes, p, net, wire_dtype),  # same wire bytes, separable halves
        "tree": lambda: tree_allreduce_time(nbytes, p, net),
        "psum": lambda: ring_allreduce_time(nbytes, p, net),
    }[method]()


def epoch_time(
    *,
    model_bytes: float,
    num_workers: int,
    num_clients: int,
    num_servers: int,
    steps_per_epoch: int,
    compute_time_per_step: float,
    net: NetParams,
    mode: str,  # "dist" (pure PS) or "mpi" (hierarchical)
    sync_every: int = 1,  # ESGD INTERVAL communicates every k steps
) -> float:
    """Fig. 12's quantity: average epoch wall time for one worker."""
    per_client = num_workers // num_clients
    if mode == "dist":
        comm = ps_pushpull_time(model_bytes, num_workers, num_servers, net)
    elif mode == "mpi":
        intra = ring_allreduce_time(model_bytes, per_client, net)
        to_ps = (
            ps_pushpull_time(model_bytes, num_clients, num_servers, net)
            if num_servers > 0
            else 0.0
        )
        comm = intra + to_ps
    else:
        raise ValueError(mode)
    return steps_per_epoch * (compute_time_per_step + comm / sync_every)
