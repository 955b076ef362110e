"""The process backend of the port's collectives (``launch/mesh.py``,
``core/collectives.RankAxis``, ``core/comm``'s ``mesh=``): gloo ranks on
the CPU, one process each, at p = 4 and (2, 2).

Every collective — the ring reduce-scatter, allgather, shard_select and
scatter-gather allreduce over the f32 / bf16 / int8 wire at 1 and 2
rings, every allreduce method, the schedule-bucketed legs, and the
``Communicator``'s hierarchical legs, splits, psum / pmean and tensor
collectives — is held ``==`` (``assert_array_equal``) to the port's
emulated backend on the same stacked numpy inputs, and the 1-axis ones
to the reference's ``repro.core.collectives.emulate`` in this process.
Each rank's ``WireMeter`` bytes equal the emulated device's and
``core.cost_model``'s. The mesh: its shape, coordinates and groups,
``spawn_ranks``' order and error path, and the production meshes'
refusal of a world of the wrong size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_mesh as TM  # noqa: E402
from _torch_net import one_thread  # noqa: E402
from repro.core import collectives as JC, flatbuf as jflatbuf  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core.comm import CollectivePolicy, Communicator  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

WORLDS = {"p4": ((4,), ("ring",)), "p2x2": ((2, 2), ("pod", "data"))}


def _x(n_dev):
    return np.random.default_rng(11).standard_normal((n_dev, TM.N)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """Each world once: the ranks' results and the emulated ones."""
    out = {}
    with one_thread():
        for name, (shape, axes) in WORLDS.items():
            x = torch.from_numpy(_x(int(np.prod(shape))))
            ranks = spawn_ranks(TM.collectives_rank, shape, axes, backend="gloo",
                                device="cpu", args=(x,))
            world = Communicator.world(axes, shape,
                                       policy=CollectivePolicy(method="ring"))
            emulated = TM.collectives_suite(world, x.reshape(shape + (TM.N,)))
            out[name] = (shape, ranks, emulated)
    return out


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


CASES = [(w, k) for w, (shape, axes) in WORLDS.items() for k in TM.suite_keys(axes)]


@pytest.mark.parametrize("world,key", CASES, ids=[f"{w}-{k}" for w, k in CASES])
def test_process_collective_equals_emulated(runs, world, key):
    shape, ranks, emulated = runs[world]
    want, want_bytes = emulated[key]
    nd = len(shape)
    for r, res in enumerate(ranks):
        got, got_bytes = res[key]
        assert got_bytes == want_bytes, (r, key)
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert tuple(g.shape[:nd]) == (1,) * nd and g.dtype == w.dtype
            row = w.reshape((-1,) + tuple(w.shape[nd:]))[r]
            np.testing.assert_array_equal(_np(g.reshape(row.shape)), _np(row),
                                          err_msg=f"rank {r} {key}")


def _rank_stack(ranks, key):
    return np.concatenate([_np(r[key][0]) for r in ranks])


@pytest.mark.parametrize("rings", TM.RINGS)
@pytest.mark.parametrize("wire", TM.WIRES)
def test_process_ring_legs_equal_reference(runs, wire, rings):
    """p = 4: the ranks' reduce-scatter, allgather, shard_select and
    scatter-gather allreduce == the reference's vmap emulation."""
    _, ranks, _ = runs["p4"]
    x = jnp.asarray(_x(4))
    rs = JC.emulate(JC.ring_reduce_scatter, x, num_rings=rings, wire_dtype=wire)
    ag = JC.emulate(JC.ring_allgather, rs, num_rings=rings, wire_dtype=wire)
    want = {"rs": rs, "ag": ag,
            "select": JC.emulate(JC.shard_select, ag, num_rings=rings),
            "sg": JC.emulate(JC.scatter_gather_allreduce, x, num_rings=rings,
                             wire_dtype=wire)}
    for k, w in want.items():
        np.testing.assert_array_equal(_rank_stack(ranks, f"{k}/{wire}/{rings}"),
                                      np.asarray(w, np.float32), err_msg=k)


@pytest.mark.parametrize("method", TM.METHODS)
def test_process_allreduce_methods_equal_reference(runs, method):
    _, ranks, _ = runs["p4"]
    want = JC.emulate(JC.allreduce, jnp.asarray(_x(4)), method=method, num_rings=2)
    np.testing.assert_array_equal(_rank_stack(ranks, f"allreduce/{method}"),
                                  np.asarray(want))


@pytest.mark.parametrize("wire", TM.WIRES)
def test_process_bucket_legs_equal_reference(runs, wire):
    _, ranks, _ = runs["p4"]
    jspec = jflatbuf.spec_for({f"l{i}": jnp.zeros(n)
                               for i, n in enumerate(TM.SCHED_LEAVES)})
    sched = jflatbuf.bucket_schedule(jspec, (1,) * len(TM.SCHED_LEAVES), 4)
    assert (sched.sizes, sched.chunks) == (TM.schedule(4).sizes, TM.schedule(4).chunks)
    x = jnp.asarray(_x(4))
    want = np.concatenate([np.asarray(JC.emulate(
        lambda v, a: JC.sched_reduce_scatter_bucket(v, a, sched, b, wire_dtype=wire),
        x[:, s:s + n])) for b, (s, n) in enumerate(zip(sched.starts, sched.sizes))], -1)
    np.testing.assert_array_equal(_rank_stack(ranks, f"bucket_rs/{wire}"), want)


@pytest.mark.parametrize("wire", TM.WIRES)
@pytest.mark.parametrize("world", list(WORLDS))
def test_process_wire_bytes_equal_cost_model(runs, world, wire):
    """Each rank's bytes of the world's reduce-scatter and allgather of
    the padded buffer (``shard_geometry``, as the driver pads) equal the
    cost model's; int8 is 0.2578125 and bf16 0.5 of the f32 bytes. (The
    free legs over ragged chunks are held == the emulated device's.)"""
    shape, ranks, _ = runs[world]
    p = int(np.prod(shape))
    _, total = Communicator.world(("x",), (p,), policy=CollectivePolicy(
        num_rings=2)).shard_geometry(TM.N)
    for res in ranks:
        assert res[f"world_rs/{wire}"][1] == cost_model.grad_leg_bytes(total * 4, p, wire)
        assert res[f"world_ag/{wire}"][1] == cost_model.param_leg_bytes(total * 4, p, wire)
        assert res[f"world_rs/{wire}"][1] == cost_model.wire_ratio(wire) * \
            res["world_rs/None"][1]


@pytest.fixture(scope="module")
def meshes():
    return {name: spawn_ranks(TM.mesh_rank, shape, axes, backend="gloo", device="cpu")
            for name, (shape, axes) in WORLDS.items()}


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_shape_coords_and_groups(meshes, world):
    shape, axes = WORLDS[world]
    got = meshes[world]
    p = int(np.prod(shape))
    # results come back ordered by rank, though rank 0 finished last
    assert [g["rank"] for g in got] == list(range(p))
    grid = np.arange(p).reshape(shape)
    for r, g in enumerate(got):
        coords = np.unravel_index(r, shape)
        assert list(g["shape"].items()) == list(zip(axes, shape))
        assert g["coords"] == dict(zip(axes, map(int, coords))) and g["index"] == r
        for i, a in enumerate(axes):
            idx = list(coords)
            idx[i] = slice(None)
            assert g["groups"][a] == grid[tuple(idx)].tolist()
        assert g["groups"]["flat"] == list(range(p))
        assert (g["backend"], g["device"], g["comm_backend"]) == ("gloo", "cpu", "process")
        assert g["sizes"] == shape and g["chips"] == p and g["threads"] == 1
        assert list(g["host_shape"].items()) == [("data", 2), ("model", p // 2)]
        assert g["host_coords"] == dict(zip(("data", "model"),
                                            map(int, np.unravel_index(r, (2, p // 2)))))


def test_production_meshes_refuse_a_world_of_another_size(meshes):
    errs = meshes["p4"][0]["errors"]
    assert errs["production"] == ("make_production_mesh needs a world of 256 ranks "
                                  "(16, 16), but the world has 4")
    assert "512 ranks (2, 16, 16), but the world has 4" in errs["production_multi"]
    assert "256 ranks (16, 8, 2), but the world has 4" in errs["moe"]


def test_spawn_ranks_raises_a_rank_error_naming_the_rank():
    with pytest.raises(RuntimeError, match=r"rank 2 of 4 raised:(.|\n)*rank 2 fails on purpose"):
        spawn_ranks(TM.failing_rank, (4,), ("dev",), backend="gloo", device="cpu",
                    args=(2,))


def test_mesh_refusals():
    from repro_torch.launch import mesh as mesh_lib

    with pytest.raises(ValueError, match="backend must be one of"):
        mesh_lib.init_mesh((1,), ("dev",), rank=0, backend="mpi", device="cpu",
                           init_method="file:///nonexistent")
    with pytest.raises(RuntimeError, match="init_mesh"):
        mesh_lib.make_host_mesh(1, 1, device="cpu")
    fake = type("M", (), {"shape": {"dev": 4}})()
    with pytest.raises(ValueError, match=r"sizes \(2,\) != the mesh's \(4,\)"):
        Communicator.world(("dev",), (2,), mesh=fake)
    with pytest.raises(ValueError, match="not in the mesh"):
        Communicator.world(("pod",), mesh=fake)
    assert Communicator.world(("dev",), mesh=fake).backend == "process"
    assert Communicator.world(("dev",), (4,)).backend == "named_axis"
