"""The port's emulated ring collectives and the int8 wire codec, held
against the reference's vmap emulation (``repro.core.collectives.emulate``
and the ``Communicator`` under nested named vmaps) on the same numpy
inputs: every per-device shard exactly equal, int8 codes included; and
the bytes the emulated hops put on the wire equal to the cost model."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import collectives as JC  # noqa: E402
from repro.core.comm import CollectivePolicy as JPolicy  # noqa: E402
from repro.core.comm import Communicator as JComm  # noqa: E402
from repro.kernels.quant_bucket import quant_bucket as jqb  # noqa: E402
from repro_torch.core import collectives as TC, cost_model, flatbuf  # noqa: E402
from repro_torch.core.comm import CollectivePolicy, Communicator  # noqa: E402
from repro_torch.kernels.quant_bucket import quant_bucket as tqb  # noqa: E402

torch.set_num_threads(2)

N = 1037          # odd: ragged chunks, ragged int8 buckets
WIRES = [None, "bf16", "int8"]


def _x(p, n=N, seed=0):
    return np.random.default_rng(seed * 100 + p).standard_normal((p, n)).astype(np.float32)


def _eq(got, want):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = np.asarray(want, np.float32) if want.dtype == jnp.bfloat16 else np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1037, 40000])
def test_wire_codec_codes_and_scales_equal_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 50.0], n)).astype(np.float32)
    x[: min(n, 5)] = 0.0
    jcodes, jscales = jqb.wire_encode(jnp.asarray(x))
    tcodes, tscales = tqb.wire_encode(torch.from_numpy(x))
    assert tcodes.dtype == torch.int8
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(jscales))
    _eq(tqb.wire_decode(tcodes, tscales, n), jqb.wire_decode(jcodes, jscales, n))
    assert tqb.wire_nbytes(n) == jqb.wire_nbytes(n)


def test_wire_codec_takes_stacked_rows():
    x = _x(3, 300)
    codes, scales = tqb.wire_encode(torch.from_numpy(x))
    for i in range(3):
        jc, js = jqb.wire_encode(jnp.asarray(x[i]))
        np.testing.assert_array_equal(codes[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(scales[i].numpy(), np.asarray(js))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("rings", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2, 8])
def test_ring_reduce_scatter_allgather_equal_reference(p, rings, wire):
    x = _x(p)
    want_rs = JC.emulate(JC.ring_reduce_scatter, jnp.asarray(x),
                         num_rings=rings, wire_dtype=wire)
    got_rs = TC.ring_reduce_scatter(torch.from_numpy(x), 0, num_rings=rings,
                                    wire_dtype=wire)
    _eq(got_rs, want_rs)
    want_ag = JC.emulate(JC.ring_allgather, want_rs, num_rings=rings,
                         wire_dtype=wire)
    got_ag = TC.ring_allgather(got_rs, 0, num_rings=rings, wire_dtype=wire)
    _eq(got_ag, want_ag)
    # replicated buffer -> each device's shard, the layout RS leaves
    full = np.repeat(np.asarray(want_ag)[:1], p, 0)
    _eq(TC.shard_select(torch.from_numpy(full), 0, num_rings=rings),
        JC.emulate(JC.shard_select, jnp.asarray(full), num_rings=rings))


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_bf16_input_rides_the_wire_as_reference(wire):
    x = _x(4).astype(jnp.bfloat16)
    want = JC.emulate(JC.ring_reduce_scatter, jnp.asarray(x), num_rings=2,
                      wire_dtype=wire)
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = TC.ring_reduce_scatter(t, 0, num_rings=2, wire_dtype=wire)
    assert got.dtype == torch.float32
    _eq(got, want)


@pytest.mark.parametrize("rings", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("method", ["ring", "multi_ring", "tree", "scatter_gather"])
def test_allreduce_methods_equal_reference(method, p, rings):
    x = _x(p, seed=3)
    want = JC.emulate(JC.allreduce, jnp.asarray(x), method=method,
                      num_rings=rings)
    got = TC.allreduce(torch.from_numpy(x), 0, method, num_rings=rings)
    _eq(got, want)


def test_tree_allreduce_needs_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        TC.tree_allreduce(torch.ones(3, 8), 0)


def _nested(comm, fn, x, shape):
    """Run ``fn(comm, per_device_value)`` under one named vmap per axis,
    the reference's emulation of a (P, D) world."""
    g = lambda v: fn(comm, v)
    for a in reversed(("pod", "data")):
        g = jax.vmap(g, axis_name=a)
    return g(jnp.asarray(x).reshape(shape + x.shape[1:]))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("group", ["world", "pod", "data"])
def test_two_axis_communicator_equals_reference(group, wire):
    """Hierarchical reduce-scatter / allgather / shard_select on a (2, 4)
    world and on each of its two splits (batched over the other axis)."""
    shape, rings = (2, 4), 2
    pol = dict(method="ring", num_rings=rings, wire_dtype=wire)
    jw = JComm.world(("pod", "data"), shape, policy=JPolicy(**pol))
    tw = Communicator.world(("pod", "data"), shape, policy=CollectivePolicy(**pol))
    jc, tc = ((jw, tw) if group == "world"
              else (jw.split(group), tw.split(group)))
    p = jc.static_size
    _, total = flatbuf.shard_geometry(N, p, rings)
    x = np.pad(_x(8, seed=5), ((0, 0), (0, total - N)))
    tx = torch.from_numpy(x).reshape(shape + (total,))
    want = _nested(jc, lambda c, v: c.reduce_scatter(v), x, shape)
    got = tc.reduce_scatter(tx)
    _eq(got, want)
    _eq(tc.allgather(got), _nested(jc, lambda c, v: c.allgather(v),
                                   np.asarray(want).reshape(8, -1), shape))
    _eq(tc.shard_select(tx), _nested(jc, lambda c, v: c.shard_select(v), x, shape))
    _eq(tc.allreduce(tx), _nested(jc, lambda c, v: c.allreduce(v), x, shape))


def test_two_axis_pmean_and_psum():
    shape = (2, 4)
    x = _x(8, 1, seed=7)[:, 0]
    jw = JComm.world(("pod", "data"), shape, policy=JPolicy(method="psum"))
    tw = Communicator.world(("pod", "data"), shape,
                            policy=CollectivePolicy(method="psum"))
    tx = torch.from_numpy(x).reshape(shape)
    for jc, tc in ((jw, tw), (jw.split("pod"), tw.split("pod")),
                   (jw.split("data"), tw.split("data"))):
        np.testing.assert_allclose(
            tc.pmean(tx).numpy(), np.asarray(_nested(jc, lambda c, v: c.pmean(v), x, shape)),
            rtol=1e-6)
    y = np.repeat(x[:, None], 3, 1)
    np.testing.assert_allclose(
        tw.allreduce(torch.from_numpy(y).reshape(shape + (3,))).numpy(),
        np.asarray(_nested(jw, lambda c, v: c.allreduce(v), y, shape)), rtol=1e-6)


@pytest.mark.parametrize("rings", [1, 2, 3])
@pytest.mark.parametrize("geometry", [((2,), ("dev",)), ((8,), ("dev",)),
                                      ((2, 4), ("pod", "data"))])
def test_counted_wire_bytes_equal_cost_model(geometry, rings):
    """Per-device bytes of the reduce-scatter and the allgather, counted
    hop by hop, equal cost_model.grad_leg_bytes / param_leg_bytes of the
    padded buffer; int8 is 0.2578125 and bf16 0.5 of the f32 bytes."""
    shape, axes = geometry
    p = int(np.prod(shape))
    counted = {}
    for wire in WIRES:
        meter = TC.WireMeter()
        comm = Communicator.world(axes, shape, meter=meter, policy=CollectivePolicy(
            method="ring", num_rings=rings, wire_dtype=wire))
        _, total = comm.shard_geometry(N, rings)
        x = torch.from_numpy(np.pad(_x(p, seed=9), ((0, 0), (0, total - N))))
        shard = comm.reduce_scatter(x.reshape(shape + (total,)), num_rings=rings)
        assert meter.bytes == cost_model.grad_leg_bytes(total * 4, p, wire)
        rs_bytes = meter.bytes
        comm.allgather(shard, num_rings=rings)
        assert meter.bytes - rs_bytes == cost_model.param_leg_bytes(total * 4, p, wire)
        counted[wire] = meter.bytes
    assert counted["int8"] / counted[None] == 0.2578125
    assert counted["bf16"] / counted[None] == 0.5
    assert cost_model.wire_ratio("int8") == 0.2578125


def test_communicator_group_algebra_equals_reference():
    from repro.core import comm as jcomm
    from repro.core.hierarchy import SyncConfig as JSync
    from repro_torch.core import comm as tcomm
    from repro_torch.core.hierarchy import SyncConfig

    jw = JComm.world(("pod", "data"), (2, 4), policy=JPolicy(num_rings=3))
    tw = Communicator.world(("pod", "data"), (2, 4), policy=CollectivePolicy(num_rings=3))
    for j, t in ((jw, tw), (jw.split("data"), tw.split("data")),
                 (jw.complement("pod"), tw.complement("pod")),
                 (jw.local(), tw.local())):
        assert (t.axes, tuple(t.sizes), t.policy.num_rings) == \
            (j.axes, tuple(j.sizes), j.policy.num_rings)
        assert t.static_size == j.static_size and t.is_trivial == j.is_trivial
        assert t.shard_geometry(10_000) == j.shard_geometry(10_000)
    for mode in ("mpi_sgd", "mpi_esgd"):
        for axes, sizes in ((("dev",), (4,)), (("pod", "data"), (2, 2))):
            jg, je = jcomm.sync_comms(JSync(mode=mode), jcomm.from_sync(JSync(), axes, sizes))
            tg, te = tcomm.sync_comms(SyncConfig(mode=mode), tcomm.from_sync(SyncConfig(), axes, sizes))
            assert tg.axes == jg.axes and (te is None) == (je is None)
            if te is not None:
                assert te.axes == je.axes
    with pytest.raises(ValueError, match="cannot split"):
        tw.split("nope")
    with pytest.raises(ValueError, match="static sizes"):
        Communicator.world(("dev",))
