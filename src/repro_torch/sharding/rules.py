"""Logical-axis -> mesh sharding rules (``repro/sharding/rules.py``), and
their placement on a DTensor mesh.

Params are nested dicts with disciplined leaf names; ``param_specs`` walks
the tree and assigns a ``P`` by (leaf name, shape). Divisibility is always
checked against the mesh: an axis that does not divide the dim is dropped
(replicated) instead of failing — this is what makes e.g. kv_heads=2
coexist with a 16-way ``model`` axis. Every spec function takes anything
with a ``.shape`` dict of axis sizes in mesh order: the port's
``launch.mesh.Mesh``, or a test double.

The reference hands its specs to XLA (``NamedSharding``), whose GSPMD
inserts the collectives. The port hands them to ``torch.distributed.
tensor``: ``placements`` turns a ``P`` into one DTensor placement per mesh
axis, ``distribute`` lays a tree out, and DTensor's redistributes are the
collectives. ``shard_batch_dim`` / ``maybe_seq_shard`` / ``expert_hint``
are the model code's hints: a redistribute on a DTensor, the tensor
unchanged on a plain one. Unlike the reference's, they swallow no error:
a redistribute that fails raises. Where DTensor cannot run a piece of the
model on the card (a batched product over two sharded dims, a pad, an
in-place cache write at a traced index), the piece runs on each rank's
local shards: ``on_local_shards`` / ``on_local_heads`` (attention, the
SSD scan, the convs), ``on_local_cache`` (decode attention),
``local_rows`` / ``rows_like`` (the MoE's per-row routing and dispatch).
Where a head axis does not divide the heads, ``fit_heads`` gathers them
before they are split, and ``grad_as_forward`` hands the gradient back
in the forward's layout before DTensor views it as heads again.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.tree import tree_flatten, tree_flatten_with_path, tree_unflatten


class P(tuple):
    """A partition spec: one entry per tensor dim, innermost last — a mesh
    axis name, a tuple of names sharded jointly (in mesh order), or None
    (replicated); trailing dims may be left out. Equal entry for entry to
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + (super().__repr__() if len(self) != 1
                      else "(" + repr(self[0]) + ")")


def is_spec(x) -> bool:
    """``is_leaf`` for spec trees: a ``P`` is a leaf, not a tuple node."""
    return isinstance(x, P)


# leaf-name regex -> logical spec (one entry per trailing dim, innermost
# last). "embed" stays replicated (activations are batch-sharded), tensor
# parallelism lives on heads/ff/vocab dims.
_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"^embedding$", ("vocab", None)),
    (r"^(lm_head|unembed)$", (None, "vocab")),
    (r"^pos_embedding$", (None, None)),
    (r"^(wq|wk|wv|wqkv)$", (None, "heads")),
    (r"^(bq|bk|bv)$", ("heads",)),
    (r"^wo$", ("heads", None)),
    (r"^(w_gate|w_up)$", (None, "ff")),
    (r"^w_down$", ("ff", None)),
    (r"^(lora_a.*)$", (None, None)),
    (r"^(lora_b.*)$", (None, "heads")),
    (r"^router$", (None, None)),
    (r"^(moe_gate|moe_up)$", ("expert", None, "ff")),
    (r"^moe_down$", ("expert", "ff", None)),
    (r"^in_proj$", (None, "ff")),      # mamba: projection dim model-sharded
    (r"^out_proj$", ("ff", None)),
    (r"^conv_w$", (None, "ff")),
    (r"^conv_b$", ("ff",)),
    (r"^(A_log|D|dt_bias)$", ("ff",)),  # per-head params follow head shards
    (r"^(scale|bias|norm.*|.*_norm)$", (None,)),
]

# logical axis -> candidate mesh axes (each candidate may be a tuple of
# axes sharded jointly); the first fully-present-and-divisible candidate
# wins. On the standard mesh everything tensor-parallel lives on 'model';
# the MoE expert-parallel mesh splits 'model' into ('expert', 'tp'):
# expert weights shard on 'expert' while the dense dims still shard over
# the combined ('expert', 'tp') axes.
_LOGICAL_TO_MESH = {
    "vocab": ("model", ("expert", "tp")),
    "heads": ("model", ("expert", "tp")),
    "ff": ("model", "tp"),
    "expert": ("expert", "model"),
    None: (),
}


def _spec_for_leaf(name: str, ndim: int) -> tuple[str | None, ...]:
    for pat, spec in _RULES:
        if re.match(pat, name):
            # stacked params carry extra leading dims -> replicate them
            pad = ndim - len(spec)
            if pad < 0:
                return tuple(spec[-ndim:]) if ndim else ()
            return (None,) * pad + tuple(spec)
    return (None,) * ndim


def logical_to_pspec(logical: tuple[str | None, ...], shape: tuple[int, ...],
                     mesh) -> P:
    axes = []
    for dim, lax_name in zip(shape, logical):
        chosen = None
        for cand in _LOGICAL_TO_MESH.get(lax_name, ()):
            parts = cand if isinstance(cand, tuple) else (cand,)
            if all(p in mesh.shape for p in parts):
                size = 1
                for p in parts:
                    size *= mesh.shape[p]
                if dim % size == 0:
                    chosen = cand
                    break
        axes.append(chosen)
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)


def _leaf_name(path: tuple) -> str:
    for kind, key in reversed(path):
        if kind == "k":
            return str(key)
    return ""


def param_specs(params: Any, mesh, *, fsdp: bool = False) -> Any:
    """``P`` tree matching ``params`` (works on ``meta`` tensors).

    ``fsdp=True`` additionally shards every weight over the ``data`` axis
    (ZeRO-3 on top of tensor parallelism): the first replicated dim that
    ``data`` divides."""

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = logical_to_pspec(_spec_for_leaf(_leaf_name(path), len(shape)),
                                shape, mesh)
        if fsdp and "data" in mesh.shape and len(shape) >= 2:
            axes = list(spec) + [None] * (len(shape) - len(spec))
            for i, (dim, ax) in enumerate(zip(shape, axes)):
                if ax is None and dim % mesh.shape["data"] == 0:
                    axes[i] = "data"
                    break
            while axes and axes[-1] is None:
                axes.pop()
            spec = P(*axes)
        return spec

    pairs, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [one(path, leaf) for path, leaf in pairs])


def batch_pspec(mesh, global_batch: int, *, extra_dims: int = 1) -> P:
    """Shard the batch dim over every data-parallel axis that divides it.

    Prefers ("pod", "data") jointly, falls back to ("data",) then
    replicated."""
    candidates = []
    if "pod" in mesh.shape and "data" in mesh.shape:
        candidates.append(("pod", "data"))
    if "data" in mesh.shape:
        candidates.append(("data",))
    for axes in candidates:
        size = math.prod(mesh.shape[a] for a in axes)
        if global_batch % size == 0:
            return P(axes if len(axes) > 1 else axes[0], *([None] * extra_dims))
    return P(None, *([None] * extra_dims))


def data_axis_names(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


# -- DTensor placement ------------------------------------------------------

def mesh_shape(mesh) -> dict:
    """Axis name -> size, in mesh order, of a ``launch.mesh.Mesh`` (or any
    ``.shape`` dict) or of a ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: P, mesh) -> list:
    """One DTensor placement per mesh axis: ``Shard(i)`` for the axis that
    tensor dim ``i``'s entry names, ``Replicate()`` for an axis no entry
    names. The axes of a tuple entry must come in mesh order — DTensor
    shards a dim over several axes mesh-major, which is ``P``'s order only
    then."""
    from torch.distributed.tensor import Replicate, Shard

    axes = list(mesh_shape(mesh))
    out = [Replicate() for _ in axes]
    used: set = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for a in names:
            if a not in axes:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which the "
                                 f"mesh {tuple(axes)} lacks")
            if a in used:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            used.add(a)
        if list(names) != [a for a in axes if a in names]:
            raise ValueError(
                f"spec {spec!r}: the axes {names} of dim {i} are not in mesh "
                f"order {tuple(axes)}")
        for a in names:
            out[axes.index(a)] = Shard(i)
    return out


def distribute(tree: Any, specs: Any, mesh, *, src_data_rank=None) -> Any:
    """Lay ``tree`` out as DTensors on ``mesh.dtensor_mesh`` by ``specs``
    (a ``P`` tree of the same structure): the counterpart of the
    reference's ``param_shardings`` + ``jax.device_put``. Plain leaves
    move to this rank's device first; DTensor leaves are taken as they
    are laid out.

    ``src_data_rank=None`` (the default) skips the broadcast: every rank
    must hold the same full values — the port's ranks build their params
    from the same seed — and keeps its own shard of them. An int names the
    rank whose values are broadcast first."""
    from torch.distributed.tensor import distribute_tensor

    dm = mesh.dtensor_mesh
    leaves, treedef = tree_flatten(tree)
    spec_leaves, spec_def = tree_flatten(specs, is_spec)
    if spec_def != treedef:
        raise ValueError(f"spec tree {spec_def} does not match {treedef}")
    return tree_unflatten(treedef, [
        t if _is_dtensor(t) else distribute_tensor(
            t.to(mesh.device), dm, placements(s, mesh), src_data_rank=src_data_rank)
        for t, s in zip(leaves, spec_leaves)])


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with every mesh axis that shards dim ``dim`` replicated (an
    all-gather); a plain tensor, or one not sharded there, unchanged."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
            for pl in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``; on DTensors, Megatron's
    vocab-parallel lookup: each rank looks its tokens up in its own rows
    of the table (the vocab dim's shards over the non-data axes; the data
    axes replicated, which is FSDP's gather at use), zero for a token
    whose row another rank holds, and one all-reduce over the vocab axes
    sums the rows — exact, as one rank contributes each. The output is laid
    out as the batch (``shard_batch_dim``'s placements); its backward is
    each rank's own rows, partial over the axes that split the batch.

    DTensor's own lookup on a vocab-sharded table leaves its rows pending
    in a masked form that neither the next op nor, under torch 2.11, the
    backward of resolving it can take."""
    import torch.nn.functional as F

    if not _is_dtensor(table):
        return F.embedding(tokens.long(), table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    shape = mesh_shape(mesh)
    if not _is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * len(shape),
                                    run_check=False)
    tokens = shard_batch_dim(tokens)
    tok_pl = list(tokens.placements)
    tab_pl, vocab_axes = [], []
    for axis, pl in zip(shape, table.placements):
        if axis not in ("pod", "data") and pl == Shard(0):
            tab_pl.append(Shard(0))
            vocab_axes.append(axis)
        else:
            tab_pl.append(Replicate())
    # the table's gradient sums over the axes that split the tokens
    grad_pl = [Partial() if isinstance(t, Shard) else pl
               for t, pl in zip(tok_pl, tab_pl)]
    local = table.redistribute(mesh, tab_pl).to_local(grad_placements=grad_pl)
    coord = dict(zip(shape, mesh.get_coordinate()))
    block = 0
    for axis in vocab_axes:  # mesh-major, as DTensor lays the shards out
        block = block * shape[axis] + coord[axis]
    lo, rows = block * local.shape[0], local.shape[0]
    ids = tokens.to_local().long()
    inside = (ids >= lo) & (ids < lo + rows)
    rows_out = F.embedding(torch.where(inside, ids - lo, 0), local)
    rows_out = rows_out * inside[..., None].to(rows_out.dtype)
    if vocab_axes:
        rows_out = _SumOverAxes.apply(rows_out, mesh, tuple(vocab_axes))
    return DTensor.from_local(rows_out, mesh, tok_pl, run_check=False)


class _SumOverAxes(torch.autograd.Function):
    """All-reduce (sum) over mesh axes forward, identity backward: the sum
    of rows each held by one rank, whose gradient is each rank's own."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        import torch.distributed._functional_collectives as funcol

        for axis in axes:
            x = funcol.wait_tensor(
                funcol.all_reduce(x, "sum", mesh.get_group(axis)))
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def shard_batch_dim(x: torch.Tensor, extra: tuple = ()) -> torch.Tensor:
    """Constrain dim 0 of ``x`` to its mesh's data axes (plus ``extra``
    specs for later dims), replicated over the other axes. Unchanged when
    ``x`` is a plain tensor, the mesh has no data axis, or the dim does
    not divide (the reference's rules)."""
    if not _is_dtensor(x):
        return x
    entry = _data_entry(x.device_mesh, x.shape[0])
    if entry is None:
        return x
    return x.redistribute(x.device_mesh, placements(P(entry, *extra), x.device_mesh))


def _data_entry(mesh, size: int):
    """The ``P`` entry that lays a dim of ``size`` over the data axes
    (('pod', 'data') jointly where both are present), or None where there
    is none or they do not divide it."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in shape)
    if not axes or size % math.prod(shape[a] for a in axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def _row_placements(x) -> list:
    """``x``'s dim 0 over the data axes (where it divides), replicated over
    the other axes: ``shard_batch_dim``'s layout."""
    return placements(P(_data_entry(x.device_mesh, x.shape[0])), x.device_mesh)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's own batch rows of ``x`` (dim 0) as a plain tensor: ``x``
    laid out as ``shard_batch_dim`` lays it, then its local shard; its
    gradient comes back in that layout. A plain tensor unchanged. Work
    that is independent per batch row (the MoE's routing and dispatch)
    runs on it as in one process."""
    if not _is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _row_placements(x)).to_local()


def rows_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, this rank's rows of a result computed from
    ``local_rows(like)``, as a DTensor laid out as ``local_rows`` read
    ``like``; ``t`` itself when ``like`` is a plain tensor."""
    if not _is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, _row_placements(like),
                              run_check=False)


def local_replica(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A replicated weight ``w`` whole, as a plain tensor, for work on
    ``local_rows(like)``: its gradient on a rank covers that rank's rows
    only, so it is partial over the data axes that split ``like``'s batch.
    ``w`` itself when ``like`` is a plain tensor."""
    if not _is_dtensor(like):
        return w
    from torch.distributed.tensor import Partial, Replicate

    mesh = like.device_mesh
    rows = _row_placements(like)
    return w.redistribute(mesh, [Replicate()] * len(rows)).to_local(
        grad_placements=[Partial() if p != Replicate() else p for p in rows])


def expert_hint(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The MoE's expert-buffer constraint for the port's (E, B·C, ...)
    layout: E on 'expert' where the mesh has that axis and it divides E,
    the B·C rows on the data axes where they divide ``like``'s batch B,
    replicated over the other axes — the reference's ``shard_batch_dim(buf,
    extra=_expert_extra(E))`` on its (B, E, C, d) buffers. Unchanged on a
    plain tensor."""
    if not _is_dtensor(y):
        return y
    mesh = y.device_mesh
    shape = mesh_shape(mesh)
    expert = ("expert" if "expert" in shape and y.shape[0] % shape["expert"] == 0
              else None)
    spec = P(expert, _data_entry(mesh, like.shape[0]))
    return y.redistribute(mesh, placements(spec, mesh))


def expert_buffer(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``buf``, an (E, B·C, ...) dispatch buffer of this rank's rows of
    ``like`` (routed from ``local_rows(like)``), as a DTensor with the B·C
    rows laid out as ``like``'s batch, then under ``expert_hint`` (no
    collective: each rank keeps its experts' slice). ``buf`` itself when
    ``like`` is a plain tensor."""
    if not _is_dtensor(like):
        return buf
    from torch.distributed.tensor import DTensor

    mesh = like.device_mesh
    pl = placements(P(None, _data_entry(mesh, like.shape[0])), mesh)
    return expert_hint(DTensor.from_local(buf, mesh, pl, run_check=False), like)


def local_expert_rows(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Every expert's slots of this rank's rows of an (E, B·C, ...) expert
    output, as a plain tensor: the B·C rows kept on the data axes as
    ``like``'s batch is, and E gathered over the axes that split it — the
    reshard after the expert FFN, an all-gather over 'expert' (the batch
    is never split there) — then the local shard. A plain tensor
    unchanged."""
    if not _is_dtensor(y):
        return y
    mesh = y.device_mesh
    spec = P(None, _data_entry(mesh, like.shape[0]))
    return y.redistribute(mesh, placements(spec, mesh)).to_local()


def fit_heads(x: torch.Tensor, heads: int, dim: int = -1) -> torch.Tensor:
    """``x`` ready to split its dim ``dim`` (the last: heads·head_dim)
    into ``heads`` groups: a DTensor whose dim is sharded over more ways
    than divide ``heads`` (a 4-way 'model' over 2 KV heads; the param
    rules shard the columns wherever the axis divides them) is gathered
    over that dim first — a shard that splits a head, or a group of query
    heads, cannot be viewed so. Unchanged otherwise."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    dim = dim % x.ndim
    ways = math.prod(n for n, pl in zip(x.device_mesh.shape, x.placements)
                     if isinstance(pl, Shard) and pl.dim % x.ndim == dim)
    return x if heads % ways == 0 else unshard_dim(x, dim)


def on_local_heads(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` with each rank computing on its own batch rows and
    heads: ``xs`` share dim 0 (batch) and dim 1 (heads), and so does
    ``fn``'s output (``on_local_shards``). Attention is independent per
    row and head, so no collective is needed inside.

    DTensor cannot run the attention core itself on the card: CUDA's
    batched matmul flattens the (batch, heads, group) dims with a view,
    and DTensor refuses to flatten two sharded dims."""
    return on_local_shards(fn, xs, [(0, 1)] * len(xs), (0, 1))


def on_local_shards(fn, xs, dims, out_dims):
    """``fn(*xs)`` with each rank computing on its own batch rows and
    heads. ``dims`` gives each input's (batch dim, heads dim), either None
    where the input has no such dim; ``out_dims`` the same for the output
    (one pair) or for each of a tuple of outputs. The batch is laid out
    over the data axes and the heads over the other axes, each axis where
    it divides (the batch of the first input that has one, the heads
    likewise), else replicated; ``fn`` runs on the local shards and its
    outputs keep that layout. An input without one of the dims is
    replicated over that dim's axes, and its gradient is partial there
    (each rank's rows or heads add their share). None inputs pass through.
    On plain tensors, simply ``fn(*xs)``.

    The SSD scan (``models/ssm``) runs so: x (B, L, H, P), dt (B, L, H),
    A (H,), Bm / Cm (B, L, N) shared by every head."""
    if not any(_is_dtensor(x) for x in xs):
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(x for x in xs if _is_dtensor(x)).device_mesh
    B = next(x.shape[b] for x, (b, _) in zip(xs, dims)
             if x is not None and b is not None)
    H = next(x.shape[h] for x, (_, h) in zip(xs, dims)
             if x is not None and h is not None)
    role, b_ways, h_ways = [], 1, 1
    for axis, n in mesh_shape(mesh).items():
        if axis in ("pod", "data") and B % (b_ways * n) == 0:
            role.append("batch")
            b_ways *= n
        elif axis not in ("pod", "data") and H % (h_ways * n) == 0:
            role.append("heads")
            h_ways *= n
        else:
            role.append(None)

    def layout(bh):
        pl, grad = [], []
        for r in role:
            d = {"batch": bh[0], "heads": bh[1]}.get(r)
            pl.append(Replicate() if d is None else Shard(d))
            grad.append(Partial() if r is not None and d is None else pl[-1])
        return pl, grad

    local = []
    for x, bh in zip(xs, dims):
        if x is None:
            local.append(None)
            continue
        pl, grad = layout(bh)
        if not _is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * len(pl),
                                   run_check=False)
        local.append(_ContiguousGrad.apply(
            x.redistribute(mesh, pl).to_local(grad_placements=grad)))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs, odims = ((out,), (out_dims,)) if single else (out, out_dims)
    wrapped = tuple(DTensor.from_local(o, mesh, layout(bh)[0], run_check=False)
                    for o, bh in zip(outs, odims))
    return wrapped[0] if single else wrapped


def on_local_cache(fn, q, k_new, v_new, k_cache, v_cache, index):
    """One decode token's attention with each rank writing and reading its
    own shard of a (B, S, KV, D) cache laid out by ``cache_specs``: the
    batch over 'data', and the KV heads over 'model' or, where 'model'
    does not divide them, the sequence. q (B, 1, H, D) and the new k / v
    (B, 1, KV, D) are laid out to match (q's heads grouped with their KV
    head), ``index`` is replicated. ``fn(q, k_new, v_new, k_cache,
    v_cache, index, lo=, size=, seq_max=, seq_sum=)`` runs on the local
    shards, its cache holding slots ``lo : lo + S_local`` of ``size``;
    ``seq_max`` / ``seq_sum`` all-reduce over the axes that split the
    sequence (the softmax's max and sum and the value product are
    contractions over it). Its (B, KV, G, D) output comes back laid out
    as the batch and the KV heads. On plain tensors, ``fn`` over the whole
    cache."""
    if not _is_dtensor(k_cache):
        return fn(q, k_new, v_new, k_cache, v_cache, index)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k_cache.device_mesh
    shape = mesh_shape(mesh)
    role = {0: "batch", 1: "seq", 2: "heads"}
    roles = []
    for axis, pl in zip(shape, k_cache.placements):
        if isinstance(pl, Shard) and pl.dim not in role:
            raise ValueError(f"cache sharded on dim {pl.dim} over {axis!r}")
        roles.append(role[pl.dim] if isinstance(pl, Shard) else None)
    new_pl = [Shard(0) if r == "batch" else Shard(2) if r == "heads"
              else Replicate() for r in roles]
    local = lambda x: x.redistribute(mesh, new_pl).to_local()
    seq_axes = [a for a, r in zip(shape, roles) if r == "seq"]
    coord = dict(zip(shape, mesh.get_coordinate()))
    block = 0
    for axis in seq_axes:       # mesh-major, as DTensor lays the shards out
        block = block * shape[axis] + coord[axis]
    kc, vc = k_cache.to_local(), v_cache.to_local()

    def over_seq(op):
        def reduce(t):
            for axis in seq_axes:
                t = funcol.wait_tensor(funcol.all_reduce(t, op, mesh.get_group(axis)))
            return t
        return reduce

    out = fn(local(q), local(k_new), local(v_new), kc, vc,
             index.redistribute(mesh, [Replicate()] * len(roles)).to_local(),
             lo=block * kc.shape[1], size=k_cache.shape[1],
             seq_max=over_seq("max"), seq_sum=over_seq("sum"))
    out_pl = [Shard(0) if r == "batch" else Shard(1) if r == "heads"
              else Replicate() for r in roles]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def grad_as_forward(x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged; on a DTensor its gradient is laid out as ``x`` is
    before the ops upstream take it. Attention's output, its heads
    gathered where the head axis does not divide the KV heads, is viewed
    from (B, KV, G, S, D) as (B, S, heads·D) columns; the product with
    ``wo`` (rows on the head axis) hands back a gradient whose columns are
    sharded 4 ways, which DTensor on the card cannot view back as 2 KV
    heads. A plain tensor unchanged."""
    if not _is_dtensor(x):
        return x
    return _GradAsForward.apply(x)


class _GradAsForward(torch.autograd.Function):
    """Identity whose backward lays the gradient out in the forward
    input's placements (``grad_as_forward``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.placements:
            return grad
        return grad.redistribute(ctx.mesh, ctx.placements)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: DTensor
    plans views on the global shape, which a strided local gradient
    (from ``fn``'s backward) cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def maybe_seq_shard(x: torch.Tensor, enabled: bool) -> torch.Tensor:
    """Sequence-parallel constraint on a (B, S, d) residual stream: batch
    on the data axes, seq on 'model'. Unchanged when disabled, on a plain
    tensor, or when the mesh or the dims do not allow it (the reference's
    rules)."""
    if not enabled or not _is_dtensor(x):
        return x
    shape = mesh_shape(x.device_mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    bsize = math.prod(shape[a] for a in batch_axes)
    if "model" not in shape or x.ndim < 3:
        return x
    if x.shape[-2] % shape["model"] or x.shape[0] % bsize:
        return x
    lead = (batch_axes if len(batch_axes) > 1
            else (batch_axes[0] if batch_axes else None))
    spec = P(lead, *([None] * (x.ndim - 3)), "model", None)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
