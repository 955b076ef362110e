"""The port's Communicator surface against the reference's
(``tests/test_comm.py``): the group algebra with its policy views
(``method``, ``num_rings``, ``bucket_bytes``, ``wire_dtype``, ``backend``),
the free ``tensor_allreduce`` / ``tensor_pushpull`` wrappers and their
refusals, ``FlatBuffer.zeros`` and ``momentum_shard_init``.

Tolerances: the views, shapes and refusals exact; the collectives' values
rtol 2e-5 / atol 2e-5 (the reference's own bound between its fused and
per-leaf paths — two orders of f32 sums).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import collectives as JC, comm as JCM, flatbuf as JF  # noqa: E402
from repro_torch.core import collectives as TC, comm as TCM, flatbuf as TF  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")

VIEWS = ("method", "num_rings", "bucket_bytes", "wire_dtype", "backend",
         "static_size", "axes", "is_trivial")


def _views(c):
    return {k: getattr(c, k) for k in VIEWS}


def _tree(n=513, leaves=4, seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.normal(size=n).astype(np.float32) for i in range(leaves)}


def _stack(tree, p):
    return {k: np.stack([v * (i + 1) for i in range(p)]) for k, v in tree.items()}


def test_world_split_complement_local_views_equal_reference():
    t = TCM.Communicator.world(("pod", "data"), (2, 4), method="multi_ring",
                               num_rings=3, bucket_bytes=1024)
    j = JCM.Communicator.world(("pod", "data"), (2, 4), method="multi_ring",
                               num_rings=3, bucket_bytes=1024)
    pairs = [(t, j), (t.split("data"), j.split("data")),
             (t.split("pod"), j.split("pod")),
             (t.complement("pod"), j.complement("pod")), (t.local(), j.local()),
             (TCM.LOCAL, JCM.LOCAL)]
    for a, b in pairs:
        assert _views(a) == _views(b)
    assert t.backend == "named_axis" and t.local().backend == "trivial"
    assert t.complement("pod") == t.split("data")
    assert t.split("data").sizes == (4,) and t.local().method == "multi_ring"
    w = TCM.Communicator.world(("data",), (4,), policy=TCM.CollectivePolicy(
        method="multi_ring", num_rings=3, bucket_bytes=1024))
    assert (w.method, w.num_rings, w.bucket_bytes, w.wire_dtype) == \
        ("multi_ring", 3, 1024, None)
    assert w.with_policy(wire_dtype="int8", method="ring").wire_dtype == "int8"
    with pytest.raises(AttributeError):
        w.num_rings = 2


@pytest.mark.parametrize("method", ["ring", "multi_ring", "tree", "psum",
                                    "scatter_gather"])
def test_tensor_allreduce_wrapper_equals_reference(method):
    tree = _tree()
    stacked = _stack(tree, 4)
    tg = TCM.Communicator.world(("r",), (4,), method=method, num_rings=2)
    jg = JCM.Communicator.world(("r",), (4,), method=method, num_rings=2)
    got = TC.tensor_allreduce({k: torch.from_numpy(v) for k, v in stacked.items()}, tg)
    want = jax.vmap(lambda t: JC.tensor_allreduce(t, jg), axis_name="r")(
        {k: jnp.asarray(v) for k, v in stacked.items()})
    same = tg.tensor_allreduce({k: torch.from_numpy(v) for k, v in stacked.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got[k], same[k], rtol=0, atol=0)
    mean = TC.tensor_allreduce({k: torch.from_numpy(v) for k, v in stacked.items()},
                               tg, mean=True)
    for k in tree:
        np.testing.assert_allclose(mean[k].numpy(), np.asarray(want[k]) / 4,
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_tensor_pushpull_wrapper_equals_reference(fused):
    tree = _tree(seed=6)
    stacked = _stack(tree, 2)
    tg = TCM.Communicator.world(("ring",), (2,))
    jg = JCM.Communicator.world(("ring",), (2,))
    got = TC.tensor_pushpull({k: torch.from_numpy(v) for k, v in stacked.items()},
                             tg, fused=fused)
    want = jax.vmap(lambda t: JC.tensor_pushpull(t, jg, fused=fused),
                    axis_name="ring")({k: jnp.asarray(v) for k, v in stacked.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[k][0].numpy(), stacked[k].mean(0),
                                   rtol=2e-5, atol=2e-5)


def test_wrappers_refuse_as_the_reference():
    stacked = {k: torch.from_numpy(v) for k, v in _stack(_tree(), 2).items()}
    group = TCM.Communicator.world(("ring",), (2,))
    # a bare axis-name string was removed (the reference raises too)
    with pytest.raises(ValueError, match="Communicator.world"):
        TC.tensor_allreduce(stacked, "ring")
    with pytest.raises(ValueError, match="Communicator.world"):
        TC.tensor_pushpull(stacked, "ring")
    with pytest.raises(ValueError, match="Communicator.from_axis_name"):
        JC.tensor_allreduce(_tree(), "ring")
    # the policy lives on the group: explicit knobs beside one are refused
    for kw in ({"method": "ring"}, {"num_rings": 2}, {"wire_dtype": "int8"}):
        with pytest.raises(ValueError, match="lives on the group"):
            TC.tensor_allreduce(stacked, group, **kw)
        jgroup = JCM.Communicator.world(("ring",), (2,))
        with pytest.raises(ValueError, match="lives on the group"):
            JC.tensor_allreduce(_tree(), jgroup, **kw)
    with pytest.raises(ValueError, match="lives on the group"):
        TC.tensor_pushpull(stacked, group, method="tree")
    # the unfused pattern is tree push + tree pull: no other method
    with pytest.raises(ValueError, match="only meaningful"):
        TC.tensor_pushpull(stacked, group, fused=False, method="multi_ring")
    with pytest.raises(ValueError, match="only meaningful"):
        JC.tensor_pushpull(_tree(), JCM.Communicator.world(("ring",), (2,)),
                           fused=False, method="multi_ring")


@pytest.mark.parametrize("n,leaves", [(513, 4), (1, 1), (4096, 3)])
def test_flatbuffer_zeros_equals_reference(n, leaves):
    tree = _tree(n, leaves)
    tspec = TF.spec_for({k: torch.from_numpy(v) for k, v in tree.items()})
    jspec = JF.spec_for({k: jnp.asarray(v) for k, v in tree.items()})
    z = tspec.zeros(device="cpu")
    jz = jspec.zeros()
    assert tuple(z.shape) == tuple(jz.shape) and z.dtype == torch.float32
    assert not z.any() and z.device.type == "cpu"


@pytest.mark.parametrize("p,num_rings,bucket_bytes", [(1, 1, None), (4, 2, None),
                                                      (8, 1, 4096), (2, 3, 1024)])
def test_momentum_shard_init_equals_reference(p, num_rings, bucket_bytes):
    tree = _tree(3000, 3)
    tspec = TF.spec_for({k: torch.from_numpy(v) for k, v in tree.items()})
    jspec = JF.spec_for({k: jnp.asarray(v) for k, v in tree.items()})
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        m = tsgd.momentum_shard_init(tspec, p, num_rings, bucket_bytes, tdt,
                                     device="cpu")
        jm = jsgd.momentum_shard_init(jspec, p, num_rings, bucket_bytes, jdt)
        assert tuple(m.shape) == tuple(jm.shape) and m.dtype == tdt
        assert not m.any()
