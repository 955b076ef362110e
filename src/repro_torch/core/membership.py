"""Elastic membership over the Communicator/KVStore stack (paper §2-3;
``repro/core/membership.py``).

MPI jobs die wholesale when one rank disappears; the paper's PS-embedded
groups instead let the membership *change between barriers*:

  ``Membership``        an epoch object tracking the live members of a
                        tier (clients, or devices under the shard
                        driver). ``fail``/``leave``/``join`` advance the
                        epoch and re-split the attached ``Communicator``
                        (``Communicator.resized`` — the MPI_Comm_split a
                        deployment would run on the survivor group),
                        appending a ``MemberEpoch`` record.

  ``reshard_optstate``  the state half of a re-split: FlatBuffer optimizer
                        state sharded 1/p_old re-laid-out to 1/p_new, every
                        SURVIVOR's shard carried over exactly and the dead
                        members' slices zero-filled (their state is lost;
                        AdaGrad/AdamW restart those stretches of
                        accumulator/moments from zero). The layout follows
                        ``core/collectives``' ring-major (num_rings, p,
                        chunk) geometry, so the result equals re-sharding
                        the reconstructed full buffer at p_new.

Byte accounting mirrors ``core/cost_model``: realizing the new layout is
an allgather among the s survivors of their old shards (each receives
s − 1 shards), so ``moved_bytes`` (per survivor) equals
``cost_model.reshard_leg_bytes(state_nbytes, p_old, survivors=s)``
exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import flatbuf
from repro_torch.core.comm import Communicator
from repro_torch.optim.sgd import FLAT_STATE_STREAMS, _flat_name, state_stream_dtype


@dataclass(frozen=True)
class MemberEpoch:
    """One membership generation: who was live, and what changed."""

    epoch: int
    live: tuple[int, ...]
    kind: str                  # "init" | "fail" | "leave" | "join"
    member: Optional[int] = None


class Membership:
    """Live-member tracking for one tier, with the Communicator re-split on
    every change.

    ``members`` is the initial roster (an int n means members 0..n-1).
    ``comm`` is the tier's group communicator; each membership change
    rebuilds ``self.comm`` over the survivor count via
    ``Communicator.resized`` (``axis`` names which axis the members live
    on when the group spans several)."""

    def __init__(self, members, comm: Optional[Communicator] = None,
                 *, axis: Optional[str] = None):
        roster = range(members) if isinstance(members, int) else members
        self._live = set(int(m) for m in roster)
        if not self._live:
            raise ValueError("membership needs at least one member")
        self.world_comm = comm
        self.axis = axis
        self.comm = comm
        self.history: list[MemberEpoch] = [MemberEpoch(0, self.live, "init")]

    # -- state ---------------------------------------------------------------
    @property
    def live(self) -> tuple[int, ...]:
        return tuple(sorted(self._live))

    @property
    def live_count(self) -> int:
        return len(self._live)

    @property
    def epoch(self) -> int:
        return self.history[-1].epoch

    def is_live(self, member: int) -> bool:
        return member in self._live

    def rank_of(self, member: int) -> int:
        """The member's dense rank in the survivor group (the color the
        re-split assigns it)."""
        if member not in self._live:
            raise KeyError(f"member {member} is not live (live: {self.live})")
        return self.live.index(member)

    # -- transitions ---------------------------------------------------------
    def fail(self, member: int) -> MemberEpoch:
        """An unannounced death (detected via timeout — see
        ``KVStore.barrier_timeout``)."""
        return self._change("fail", member)

    def leave(self, member: int) -> MemberEpoch:
        """A graceful departure (preemption notice, scale-down)."""
        return self._change("leave", member)

    def join(self, member: int) -> MemberEpoch:
        """A (re)join: the member enters at the NEXT epoch with fresh state
        (``reshard_optstate`` zero-fills its slices)."""
        if member in self._live:
            raise ValueError(f"member {member} is already live")
        self._live.add(int(member))
        return self._record("join", member)

    def _change(self, kind: str, member: int) -> MemberEpoch:
        if member not in self._live:
            raise ValueError(
                f"cannot {kind} member {member}: not live (live: {self.live})")
        if len(self._live) == 1:
            raise ValueError(
                f"cannot {kind} the last live member {member} — a tier "
                "with zero members has no survivor group to re-split to")
        self._live.discard(member)
        return self._record(kind, member)

    def _record(self, kind: str, member: int) -> MemberEpoch:
        if self.world_comm is not None:
            self.comm = self.world_comm.resized(self.live_count, axis=self.axis)
        ep = MemberEpoch(self.epoch + 1, self.live, kind, member)
        self.history.append(ep)
        return ep


# ---------------------------------------------------------------------------
# State re-shard: survivors' FlatBuffer optimizer shards re-laid-out
# ---------------------------------------------------------------------------

def _reshard_stream(stream: torch.Tensor, n: int, p_old: int, p_new: int,
                    survivors: Sequence[int], nr: int) -> torch.Tensor:
    """Re-layout ONE stacked state stream (p_old, …, shard_old) ->
    (p_new, …, shard_new) under the ring-major (nr, p, chunk) flat
    geometry: old device d owned ``full.reshape(nr, p_old, chunk)[:, d]``;
    the same identity at p_new defines the new shards. Dead members'
    slices of the reconstructed buffer stay zero."""
    lead = tuple(stream.shape[1:-1])
    chunk_o, total_o = flatbuf.shard_geometry(n, p_old, nr)
    chunk_n, total_n = flatbuf.shard_geometry(n, p_new, nr)
    full = stream.new_zeros(lead + (nr, p_old, chunk_o))
    for d in survivors:
        full[..., d, :] = stream[d].reshape(lead + (nr, chunk_o))
    flat = stream.new_zeros(lead + (total_n,))
    flat[..., :n] = full.reshape(lead + (total_o,))[..., :n]
    view = flat.reshape(lead + (nr, p_new, chunk_n))
    return torch.stack([view[..., d, :].reshape(lead + (nr * chunk_n,))
                        for d in range(p_new)])


def reshard_optstate(hyper, spec: flatbuf.FlatBuffer, stacked_state: Any,
                     p_old: int, p_new: int, *,
                     survivors: Optional[Sequence[int]] = None,
                     num_rings: int = 1,
                     bucket_bytes: Optional[int] = None,
                     state_dtypes=None) -> tuple[Any, dict]:
    """Re-shard stacked flat optimizer state across a membership change.

    ``stacked_state`` carries a leading p_old device dim (the shard
    driver's layout); ``survivors`` names the OLD ranks whose shards carry
    over, in their new rank order (default: the first p_new old ranks — a
    clean scale-down). Every family ``optstate_shard_init`` lays out is
    handled: sgd/adagrad's (n,) stream, adamw's {"mv": (2, n), "t": ()}
    pair (t is a per-device scalar: survivors keep theirs, joiners inherit
    the first survivor's count).

    Returns ``(new_stacked_state, info)``; info carries the byte
    accounting the cost model mirrors:

      state_nbytes  total bytes of the full-length state streams
                    (p_old × per-shard bytes)
      moved_bytes   wire bytes ONE survivor receives to realize the new
                    layout (the (s − 1)-shard allgather leg) — equal to
                    ``cost_model.reshard_leg_bytes(state_nbytes, p_old,
                    survivors=s)``
    """
    if survivors is None:
        survivors = tuple(range(min(p_old, p_new)))
    survivors = tuple(int(s) for s in survivors)
    if len(set(survivors)) != len(survivors):
        raise ValueError(f"duplicate survivors: {survivors}")
    bad = [s for s in survivors if not 0 <= s < p_old]
    if bad:
        raise ValueError(
            f"survivors {bad} outside the old device range [0, {p_old})")
    if len(survivors) > p_new:
        raise ValueError(
            f"{len(survivors)} survivors cannot fit a {p_new}-way layout")

    name = _flat_name(hyper)
    if name not in FLAT_STATE_STREAMS:
        raise ValueError(
            f"reshard_optstate knows the flat families "
            f"{sorted(FLAT_STATE_STREAMS)}, got {name!r}")
    sd = state_stream_dtype(hyper, state_dtypes)
    nr = flatbuf.effective_rings(spec.nbytes, num_rings, bucket_bytes)
    n = spec.size

    stream = stacked_state["mv"] if name == "adamw" else stacked_state
    want_shard = flatbuf.shard_size(spec, p_old, num_rings, bucket_bytes)
    if stream.shape[0] != p_old or stream.shape[-1] != want_shard:
        raise ValueError(
            f"stacked state has shape {tuple(stream.shape)} but the "
            f"{p_old}-way ring-{nr} layout of this spec needs a leading dim "
            f"{p_old} and shard length {want_shard} — was it built with "
            "optstate_shard_init under the same geometry?")

    new_stream = _reshard_stream(stream, n, p_old, p_new, survivors, nr).to(sd)
    if name == "adamw":
        t = stacked_state["t"]
        keep = t[survivors[0]] if survivors else t.new_zeros(())
        new_t = keep.expand((p_new,) + tuple(t.shape[1:])).clone()
        for new_rank, d in enumerate(survivors):
            new_t[new_rank] = t[d]
        new_state: Any = {"mv": new_stream, "t": new_t}
    else:
        new_state = new_stream

    shard_nbytes = stream[0].numel() * stream.element_size()
    s = len(survivors)
    info = {
        "state_nbytes": p_old * shard_nbytes,
        "moved_bytes": float((s - 1) * shard_nbytes) if s > 1 else 0.0,
        "survivors": survivors,
        "p_old": p_old,
        "p_new": p_new,
        "num_rings": nr,
    }
    return new_state, info
