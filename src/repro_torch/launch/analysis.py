"""Compiled-artifact analysis: collective bytes and the three-term
roofline (``repro/launch/analysis.py``).

    compute term    = FLOPs / (chips × peak FLOP/s)
    memory term     = bytes / (chips × HBM bandwidth)
    collective term = wire_bytes / (chips × link bandwidth)

``parse_collectives`` reads optimized HLO text (a pure string function)
and charges each collective its ring wire cost on the group it runs over
(``collective_cost``, which ``launch.dryrun``'s trace of the port's own
collectives calls too); the roofline's FLOP and byte counts come from the
caller's cost analysis.

The rates are the card's, not the reference's: every function that
reads one takes it as a keyword whose default is the NVIDIA H100 SXM
data sheet's (80GB HBM3, 700 W; dense bf16 989 TFLOP/s, HBM3 3.35 TB/s —
the same peaks PERF.md's bounds use; chip_smoke's ``[launch]`` phase
prints the card's measured rates beside them). There is no link default:
no link between two cards has been measured, so the collective term
takes its bandwidth from the caller.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass, field
from typing import Optional

#: NVIDIA H100 SXM (80GB HBM3, 700 W) data sheet, dense bf16 FLOP/s
PEAK_FLOPS = 989e12
#: NVIDIA H100 SXM (80GB HBM3, 700 W) data sheet, HBM3 bytes/s
HBM_BW = 3.35e12

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+(?:\()?([a-z0-9]+)\[([0-9,]*)\][^=]*?"
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_GROUP_RE = re.compile(r"replica_groups=\{\{([0-9,]+)")
_GROUP_RE2 = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    operand_bytes: dict = field(default_factory=dict)
    wire_bytes: float = 0.0

    def total_ops(self) -> int:
        return sum(self.counts.values())


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


#: torch's collective ops (``_c10d_functional`` / ``_dtensor``, by schema
#: name) -> the kind of collective, by the reference's HLO names
TORCH_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def collective_cost(op: str, nbytes: float, group_size: int) -> tuple[str, float]:
    """``(kind, wire bytes)`` of one collective: ``op`` is a kind (an HLO
    name) or a torch collective op's schema name, ``nbytes`` its result's
    bytes on one device, ``group_size`` g (0 when unknown).

    Wire-cost convention (ring algorithms, group size g):
      all-reduce        2·(g−1)/g · bytes   (reduce-scatter + all-gather)
      all-gather        (g−1)/g · out_bytes
      reduce-scatter    (g−1)/g · in_bytes  (result type is the shard => ·(g−1))
      all-to-all        (g−1)/g · bytes
      collective-permute  bytes
    An unknown group (g = 0) is taken as g→∞ (factor 1)."""
    kind = TORCH_COLLECTIVE_KINDS.get(op, op)
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"{op!r} is no collective this analysis prices")
    g = group_size
    frac = (g - 1) / g if g > 1 else 1.0
    if kind == "all-reduce":
        wire = 2 * frac * nbytes
    elif kind == "reduce-scatter":
        wire = (g - 1) * nbytes if g > 1 else nbytes
    elif kind == "collective-permute":
        wire = nbytes
    else:  # all-gather, all-to-all
        wire = frac * nbytes
    return kind, wire


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum per-device collective bytes from optimized HLO text, each op
    charged ``collective_cost``'s ring wire bytes on its group, whose size
    is parsed per op from replica_groups."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.groups()
        nbytes = _shape_bytes(dtype, dims)
        kind, wire = collective_cost(kind, nbytes, _group_size(line))
        stats.counts[kind] = stats.counts.get(kind, 0) + 1
        stats.operand_bytes[kind] = stats.operand_bytes.get(kind, 0) + nbytes
        stats.wire_bytes += wire
    return stats


def _group_size(line: str) -> int:
    m = _GROUP_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUP_RE2.search(line)
    if m:  # iota groups: [num_groups,group_size]
        return int(m.group(2))
    return 0


@dataclass
class Roofline:
    chips: int
    hlo_flops: float            # whole-job flops
    hlo_bytes: float            # whole-job HBM traffic
    wire_bytes: float           # whole-job collective wire bytes
    compute_s: float
    memory_s: float
    collective_s: Optional[float]     # None: no link rate was given
    model_flops: float = 0.0

    def _terms(self) -> dict:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        """The largest of the terms that have a rate."""
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["dominant"] = self.dominant
        d["useful_flops_ratio"] = self.useful_flops_ratio
        return d


def roofline_from_analysis(cost: dict, coll: CollectiveStats, chips: int,
                           model_flops: float = 0.0,
                           wire_dtype: "str | None" = None, *,
                           link_bw: Optional[float],
                           peak_flops: float = PEAK_FLOPS,
                           hbm_bw: float = HBM_BW) -> Roofline:
    """The three terms from a per-device cost analysis (``"flops"``,
    ``"bytes accessed"``) and the parsed collectives. ``wire_dtype``
    projects the low-precision wire onto a module traced at full
    precision (``cost_model.wire_ratio`` of the f32 bytes per hop);
    ``link_bw`` (bytes/s per link) has no default: None leaves the
    collective term unpriced (``collective_s`` None)."""
    from repro_torch.core.cost_model import wire_ratio

    per_dev_flops = float(cost.get("flops", 0.0))
    per_dev_bytes = float(cost.get("bytes accessed", 0.0))
    per_dev_wire = coll.wire_bytes * wire_ratio(wire_dtype)
    return Roofline(
        chips=chips,
        hlo_flops=per_dev_flops * chips,
        hlo_bytes=per_dev_bytes * chips,
        wire_bytes=per_dev_wire * chips,
        compute_s=per_dev_flops / peak_flops,
        memory_s=per_dev_bytes / hbm_bw,
        collective_s=None if link_bw is None else per_dev_wire / link_bw,
        model_flops=model_flops,
    )


def overlap_projection(nbytes: float, p: int, compute_s: float, *,
                       bucket_bytes: "list[float] | None" = None,
                       num_buckets: int = 4,
                       wire_dtype: "str | None" = None,
                       net=None) -> dict:
    """Modeled step time with and without the backward-overlapped
    bucketed reduce-scatter, next to the wire-dtype projection.

    ``nbytes`` is the packed gradient payload (f32 bytes), ``p`` the
    ring size, ``compute_s`` the per-step compute time the bucket legs
    hide behind. ``bucket_bytes`` gives the real schedule partition
    (``flatbuf.BucketSchedule.sizes`` × itemsize); omitted, an even
    ``num_buckets`` split stands in. ``net`` defaults to
    ``cost_model.testbed()``, the paper's IB ConnectX-4 cluster. Keys:
    ``overlap_fraction``, ``step_no_overlap_s``, ``step_overlap_s``,
    ``hidden_s``, ``speedup``.
    """
    from repro_torch.core import cost_model

    net = net or cost_model.testbed()
    bb = (list(bucket_bytes) if bucket_bytes
          else [nbytes / num_buckets] * num_buckets)
    no = cost_model.overlapped_step_time(compute_s, [nbytes], p, net,
                                         wire_dtype)
    ov = cost_model.overlapped_step_time(compute_s, bb, p, net, wire_dtype)
    return {
        "overlap_fraction": cost_model.overlap_fraction(bb, p),
        "step_no_overlap_s": no,
        "step_overlap_s": ov,
        "hidden_s": no - ov,
        "speedup": no / ov if ov else 1.0,
    }


def train_model_flops(param_count: int, active_param_count: int,
                      tokens: int) -> float:
    """6·N·D (N = active params for MoE)."""
    return 6.0 * active_param_count * tokens


def enc_dec_model_flops(cfg, batch: int, dec_tokens_per_seq: int,
                        train: bool = True) -> float:
    """Enc-dec (whisper): encoder params see B·enc_seq tokens, decoder
    params see B·S tokens — 6·N·T per side (2·N·T forward-only)."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    attn = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * h + cfg.num_heads * h * d
    enc_n = cfg.enc_layers * (attn + 2 * d * cfg.d_ff)
    dec_n = cfg.num_layers * (2 * attn + 2 * d * cfg.d_ff)  # self + cross
    dec_n += 2 * cfg.padded_vocab * d  # embed + unembed
    mult = 6.0 if train else 2.0
    t_dec = batch * dec_tokens_per_seq
    t_enc = batch * cfg.enc_seq_len
    return mult * (enc_n * t_enc + dec_n * t_dec)


def decode_model_flops(active_param_count: int, batch: int) -> float:
    """One token per sequence: 2·N·B forward."""
    return 2.0 * active_param_count * batch


def memory_summary(mem) -> dict:
    """The byte counts an object carries as attributes (a compiled
    module's memory analysis, or anything shaped like one)."""
    keys = (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    out = {}
    for k in keys:
        v = getattr(mem, k, None)
        if v is not None:
            out[k] = int(v)
    return out
