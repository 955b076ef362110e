"""Device meshes over one process per device (``repro/launch/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` over the devices of one
program. The port's is a world of processes, one per device, joined by
``torch.distributed``: ``Mesh`` wraps the ``DeviceMesh`` of that world
and gives the collectives (``core.comm``'s process backend) what they
need — each axis' process group, this rank's coordinates, the flattened
group over several axes, and the ``collectives.Link`` the messages cross.

``init_mesh`` joins this process to a world; ``spawn_ranks`` starts one
(the counterpart of the reference's ``--xla_force_host_platform_device_
count``: p processes on one host). The production meshes build over a
world that is already joined. Importing this module touches no process
group.

The backend is named by the caller, never switched: "gloo" (host
transport; any number of ranks on one card, card tensors staged through
pinned host memory) or "nccl" (one card a rank). A world joined over
torch's "fake" backend (``join_trace_world``: one process that plays one
rank of a world of any size and sends nothing) is laid out as a
``TraceMesh``: its tensors are ``meta`` and its DTensors live on a mesh
of the traced device type, for ``launch.dryrun``.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import math
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.collectives import Link, RankAxis

BACKENDS = ("gloo", "nccl")
#: a collective that waits longer than this raises instead of hanging
PG_TIMEOUT_S = 120.0
#: a ``spawn_ranks`` job still running after this long is stopped
SPAWN_TIMEOUT_S = 600.0


class Mesh:
    """This rank's view of a process world laid out as named axes.

    ``shape`` maps each axis name to its size, in axis order (as jax's
    ``Mesh.shape``); ``coords`` maps it to this rank's coordinate;
    ``index`` is this rank's pod-major position in the world — its row
    of a stacked (p_total-leading) driver state."""

    def __init__(self, device_mesh, *, backend: str, device):
        self.device_mesh = device_mesh
        self.axes = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axes, device_mesh.mesh.shape))
        self.backend = backend
        self.device = torch.device(device)
        self.coords = dict(zip(self.axes, device_mesh.get_coordinate()))
        self.link = self._make_link()
        self._groups: dict = {}
        self._dtensor_meshes: dict = {}
        for a in self.axes:
            # the ring's peers are addressed by coordinate
            g = self.get_group(a)
            if dist.get_group_rank(g, dist.get_rank()) != self.coords[a]:
                raise RuntimeError(f"axis {a!r}: group rank != coordinate")

    def _make_link(self):
        return Link(self.backend, self.device)

    @property
    def dtensor_device_type(self) -> str:
        """The device type of the ``DeviceMesh`` this world's DTensors live
        on: this rank's."""
        return self.device.type

    @property
    def index(self) -> int:
        idx = 0
        for a in self.axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    @property
    def size(self) -> int:
        return mesh_num_chips(self)

    def get_group(self, axes):
        """The process group of one axis (a name) or of several flattened
        (a tuple, in mesh order: its group ranks run pod-major over
        them). A flattened group is made on first use, by every rank in
        the same order, as SPMD code asks for it."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if list(axes) != [a for a in self.axes if a in axes]:
            raise ValueError(f"axes {axes} are not in mesh order {self.axes}")
        if axes not in self._groups:
            ranks = self.device_mesh.mesh.permute(
                [self.axes.index(a) for a in self.axes if a not in axes]
                + [self.axes.index(a) for a in axes])
            ranks = ranks.reshape(-1, math.prod(self.shape[a] for a in axes))
            mine = None
            for row in ranks.tolist():
                g = dist.new_group(row)
                if dist.get_rank() in row:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    @property
    def dtensor_mesh(self):
        """The ``DeviceMesh`` this world's DTensors live on (the GSPMD
        path): ``device_mesh`` when its device type is this rank's, else
        one over the same axis groups with this rank's device type — gloo
        ranks that hold card tensors."""
        return self.dtensor_submesh(self.axes)

    def dtensor_submesh(self, axes):
        """The ``DeviceMesh`` over ``axes`` (in mesh order) through this
        rank, for DTensors: each axis keeps its own process group; the
        axes left out are fixed at this rank's coordinates (the mesh of
        one client when 'pod' is left out)."""
        axes = tuple(axes)
        if list(axes) != [a for a in self.axes if a in axes]:
            raise ValueError(f"axes {axes} are not in mesh order {self.axes}")
        dev_type = self.dtensor_device_type
        if axes == self.axes and self.device_mesh.device_type == dev_type:
            return self.device_mesh
        if axes not in self._dtensor_meshes:
            from torch.distributed.device_mesh import DeviceMesh

            ranks = self.device_mesh.mesh[tuple(
                slice(None) if a in axes else self.coords[a]
                for a in self.axes)]
            self._dtensor_meshes[axes] = DeviceMesh.from_group(
                [self.device_mesh.get_group(a) for a in axes],
                dev_type, mesh=ranks, mesh_dim_names=axes)
        return self._dtensor_meshes[axes]

    def dtensor_collectives(self):
        """The context the GSPMD path runs its DTensor ops in: under gloo
        with card tensors every collective staged through pinned host
        memory (``sharding.staging.StagedCollectives``, counted in
        ``link.stats``); otherwise nothing to do."""
        if self.link.staged:
            from repro_torch.sharding.staging import StagedCollectives

            return StagedCollectives(self.link)
        return contextlib.nullcontext()

    def rank_axis(self, axis: str, dim: int) -> RankAxis:
        """``axis`` as the collectives address it, at leading dim ``dim``
        of this rank's block."""
        return RankAxis(dim=dim, size=self.shape[axis],
                        coord=self.coords[axis], group=self.get_group(axis),
                        link=self.link)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device}, coords={self.coords})")


class TraceMesh(Mesh):
    """A ``Mesh`` over a "fake" world (``join_trace_world``) that traces:
    this process plays rank 0 of the world and moves nothing. Its tensors
    are ``meta`` — shapes and dtypes, no storage — and its DTensors live on
    a ``DeviceMesh`` of ``TRACED_DEVICE_TYPE``, the device the traced
    deployment runs on, so DTensor plans the collectives it would plan
    there (a CPU mesh turns DTensor's all-to-all into an all-gather). No
    ``Link``: no tensor is staged, and ``dtensor_collectives`` does
    nothing — a tracer (``launch.dryrun``'s recorder) sees the collectives
    as they are issued."""

    def __init__(self, device_mesh, *, backend: str, device):
        if torch.device(device).type != "meta":
            raise ValueError(f"a trace mesh holds meta tensors, not {device}")
        super().__init__(device_mesh, backend=backend, device=device)

    def _make_link(self):
        return None

    @property
    def dtensor_device_type(self) -> str:
        return TRACED_DEVICE_TYPE

    def dtensor_collectives(self):
        return contextlib.nullcontext()


#: the device type a ``TraceMesh``'s DTensors are laid out for
TRACED_DEVICE_TYPE = "cuda"


def join_trace_world(world_size: int) -> None:
    """Join this process, as rank 0, to a "fake" world of ``world_size``
    ranks: every collective returns at once and moves nothing (a trace
    records it instead). The production meshes then build over it as
    ``TraceMesh``es, on ``device="meta"``."""
    # importing it registers the backend (torch's own default for "fake")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _rank_device(device, rank: int) -> torch.device:
    """The card of ``rank``: an index-less "cuda" maps ranks round-robin
    over the host's cards (all on card 0 on a one-card host). A CUDA
    request with no CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run the ranks on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _mesh_over_world(shape: Sequence[int], axes: Sequence[str], device,
                     what: str) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"{what} builds over a joined world: call "
                           "init_mesh (or run under spawn_ranks) first")
    need, have = math.prod(shape), dist.get_world_size()
    if need != have:
        raise ValueError(f"{what} needs a world of {need} ranks "
                         f"{tuple(shape)}, but the world has {have}")
    backend = dist.get_backend()
    device = _rank_device(device, dist.get_rank())
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(shape), mesh_dim_names=tuple(axes))
    cls = TraceMesh if backend == "fake" else Mesh
    return cls(dm, backend=backend, device=device)


def init_mesh(shape: Sequence[int], axes: Sequence[str], *, rank: int,
              backend: str, device="cuda", init_method: str) -> Mesh:
    """Join this process, as ``rank``, to a world of prod(``shape``)
    ranks over ``backend`` ("gloo" or "nccl") and lay it out as ``axes``.
    Collectives time out after ``PG_TIMEOUT_S``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = _rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank,
        world_size=math.prod(shape),
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return _mesh_over_world(shape, axes, device, "init_mesh")


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production layout over the joined world: 256 ranks
    as (16, 16) ('data', 'model'); 2 pods add the 'pod' axis (512).

    'data' carries the intra-client gradient ring (the MPI communicator),
    'model' tensor parallelism, 'pod' the PS tier (one client per pod;
    crossed only by the lazy elastic exchange)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh_over_world(shape, axes, device, "make_production_mesh")


def make_moe_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Expert-parallel variant of the production pod: the 16-way model
    axis splits into ('expert', 'tp') = (8, 2)."""
    shape = (2, 16, 8, 2) if multi_pod else (16, 8, 2)
    axes = (("pod",) if multi_pod else ()) + ("data", "expert", "tp")
    return _mesh_over_world(shape, axes, device, "make_moe_mesh")


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda") -> Mesh:
    """A small ('data', 'model') mesh over the joined world."""
    return _mesh_over_world((data, model), ("data", "model"), device,
                            "make_host_mesh")


def mesh_num_chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _pack(msg) -> bytes:
    """One ``torch.save`` of a whole message: one archive for all its
    tensors (pickling them one by one archives each alone)."""
    buf = io.BytesIO()
    torch.save(msg, buf)
    return buf.getvalue()


def _rank_main(rank, fn, shape, axes, backend, device, init_method, args,
               results) -> None:
    """One spawned rank: one BLAS thread, join the world, run ``fn(mesh,
    *args)``, report ``(rank, ok, result or traceback)``, leave."""
    try:
        torch.set_num_threads(1)
        mesh = init_mesh(shape, axes, rank=rank, backend=backend,
                         device=device, init_method=init_method)
        try:
            out = _to_host(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
        results.put(_pack((rank, True, out)))
    except Exception:
        results.put(_pack((rank, False, traceback.format_exc())))
        raise


def spawn_ranks(fn: Callable, shape: Sequence[int], axes: Sequence[str], *,
                backend: str, device="cuda", args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` in prod(``shape``) new processes, one per
    rank of a world laid out as ``axes``; return their results ordered by
    rank (tensors moved to the host).

    ``fn`` and ``args`` are pickled (``fn`` by import path). The ranks
    meet at a ``file://`` store in a temporary directory (no port), run
    one BLAS thread each, and leave the world when ``fn`` returns. A
    rank's exception is raised again here, naming the rank, and the
    other ranks are stopped; so is a job still running after
    ``SPAWN_TIMEOUT_S``."""
    _rank_device(device, 0)     # no card: raise here, not in every rank
    ctx = mp.get_context("spawn")
    n = math.prod(shape)
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, tuple(shape), tuple(axes), backend,
                                   device, init, args, results),
                             name=f"rank-{r}")
                 for r in range(n)]
        out: list = [None] * n
        done: set = set()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            for p in procs:
                p.start()
            while len(done) < n:
                try:
                    r, ok, payload = torch.load(
                        io.BytesIO(results.get(timeout=0.5)),
                        weights_only=False)
                except queue.Empty:
                    lost = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if lost:
                        raise RuntimeError(
                            f"rank {lost[0]} of {n} exited with code "
                            f"{procs[lost[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(n)) - done)} of {n} "
                            f"still running after {SPAWN_TIMEOUT_S} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} of {n} raised:\n{payload}")
                out[r] = payload
                done.add(r)
            for p in procs:
                p.join(timeout=60.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
    return out
