"""The port's grouped-vector reduction (``repro_torch.kernels.tensor_reduce``:
the plain version, the CPU path of ``group_reduce_flat``) against the
reference's Pallas ``group_reduce_flat`` in interpret mode and its jitted
``ops.group_reduce``, on the same numpy inputs; and ``KVStore``'s list
push (``local_reduce``) against the reference's.

Tolerance: exactly equal, f32 and bf16, for G in {2, 3, 8} and ragged N —
the reference's interpret-mode reduction is the sequential f32 sum in
member order, and the port adds in that order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.kvstore import KVStore as JKV, local_reduce as jlocal  # noqa: E402
from repro.kernels.tensor_reduce import ops as jops, tensor_reduce as jtr  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.kvstore import KVStore as TKV, local_reduce as tlocal  # noqa: E402
from repro_torch.kernels.tensor_reduce import ops as tops, tensor_reduce as ttr  # noqa: E402

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _group(G, n, seed):
    """Values across many binades, so the order of the adds shows."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, n)) * np.exp(3 * rng.standard_normal((G, n)))
            ).astype(np.float32)


def _pair(x, dtype):
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(DTYPES[dtype][1])
    return jx, tx


def _equal(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 1000, 4097, 65536 + 3])
@pytest.mark.parametrize("G", [2, 3, 8])
def test_group_reduce_flat_plain_matches_pallas(G, n, dtype):
    jx, tx = _pair(_group(G, n, 100 * G + n % 97), dtype)
    before = ttr.group_reduce_flat.launches
    got = ttr.group_reduce_flat(tx)
    assert ttr.group_reduce_flat.launches == before        # CPU: no launch
    assert got.dtype == tx.dtype
    _equal(got, jtr.group_reduce_flat(jx, interpret=True))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_reduce_shapes_match_reference(dtype):
    """``ops.group_reduce``: (G, …) -> (…), any trailing shape."""
    for G, shape in ((2, (7, 11, 2)), (3, (129,)), (8, (3, 50))):
        x = _group(G, int(np.prod(shape)), G).reshape((G,) + shape)
        jx, tx = _pair(x, dtype)
        _equal(tops.group_reduce(tx), jops.group_reduce(jx))


def test_list_push_reduces_like_reference():
    """A list push of several device trees: ``local_reduce`` leaf by leaf,
    then the store's rule, equal to the reference's."""
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 50), "b": {"c": (129,), "d": (7, 11, 2)}}

    def tree():
        return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))

    trees = [tree() for _ in range(3)]
    want = jlocal([jax.tree.map(jnp.asarray, t) for t in trees])
    got = tlocal([params_from_numpy(t) for t in trees])
    for g, w in zip(jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    stores = []
    for KV, wrap in ((JKV, lambda t: jax.tree.map(jnp.asarray, t)), (TKV, params_from_numpy)):
        kv = KV.create("dist_sync", num_workers=2)
        kv.init("g", wrap(trees[0]))
        kv.push("g", [wrap(t) for t in trees[:2]])
        kv.push("g", [wrap(t) for t in trees[1:]])
        stores.append((kv.value("g"), kv.pushed_bytes, kv.push_count["g"]))
    (jv, jb, jc), (tv, tb, tc) = stores
    assert (tb, tc) == (jb, jc)
    for g, w in zip(jax.tree.leaves(params_to_numpy(tv)), jax.tree.leaves(jv)):
        np.testing.assert_array_equal(g, np.asarray(w))
