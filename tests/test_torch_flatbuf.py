"""The port's FlatBuffer layout held EXACTLY against the reference's, for
reduced and full-width qwen2-0.5b (full width from shapes only: ``meta``
params against ``jax.eval_shape``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core import flatbuf as jfb  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import flatbuf as tfb  # noqa: E402
from repro_torch.launch.train import grad_spec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, path_str  # noqa: E402

torch.set_num_threads(2)


def _specs(full: bool):
    jcfg, tcfg = jget_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    if not full:
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    jabs = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    return jfb.spec_for(jabs), grad_spec(build_model(tcfg)), jabs


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_spec_layout_equals_reference(full):
    js, ts, _ = _specs(full)
    assert ts.offsets == js.offsets
    assert ts.sizes == js.sizes
    assert ts.size == js.size
    assert ts.shapes == js.shapes
    assert [str(d).replace("torch.", "") for d in ts.dtypes] == \
        [str(d) for d in js.dtypes]
    assert ts.payload == js.payload and ts.nbytes == js.nbytes
    for p, rings in [(1, 1), (1, 2), (2, 2), (8, 1), (8, 3)]:
        assert tfb.shard_size(ts, p, rings) == jfb.shard_size(js, p, rings)


def test_full_width_state_length():
    """The p=1 state length of full qwen2-0.5b under the default policy
    (num_rings=2) is shard_size, not spec.size — equal here by layout."""
    _, ts, _ = _specs(True)
    assert ts.payload == 494_147_456
    assert ts.size == 494_147_584
    assert tfb.shard_size(ts, 1, 2) == 494_147_584
    assert ts.num_leaves == 14


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_leaf_order_is_sorted_key_order(full):
    """Leaf paths in the reference's flatten order (sorted keys)."""
    _, ts, jabs = _specs(full)
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jabs)[0]]
    tpaths, _ = tree_flatten_with_path(build_model(
        get_config("qwen2-0.5b") if full else reduced(get_config("qwen2-0.5b"))
    ).init(device="meta"))
    assert [path_str(p) for p, _ in tpaths] == [
        "/".join("k:" + k.strip("[]'") for k in jp.split("][")) for jp in jpaths]


def test_pack_of_bridged_params_equals_reference():
    cfg = jreduced(jget_config("qwen2-0.5b"))
    jparams = jbuild(cfg).init(jax.random.key(3))
    js = jfb.spec_for(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    ts = tfb.spec_for(tparams)
    np.testing.assert_array_equal(ts.pack(tparams).numpy(),
                                  np.asarray(js.pack(jparams)))
    _, total = jfb.shard_geometry(js.size, 1, 2)
    np.testing.assert_array_equal(
        tfb.pack_padded(ts, tparams, total + 1024).numpy(),
        np.asarray(jfb.pack_padded(js, jparams, total + 1024)))
    back = ts.unpack(ts.pack(tparams))
    for a, b in zip(tree_flatten_with_path(back)[0],
                    tree_flatten_with_path(tparams)[0]):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


def test_pack_widens_bf16_and_unpack_rounds_back():
    cfg = jget_config("qwen2-0.5b")
    cfg = type(cfg)(**{**jreduced(cfg).__dict__, "dtype": "bfloat16"})
    jparams = jbuild(cfg).init(jax.random.key(5))
    js = jfb.spec_for(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    ts = tfb.spec_for(tparams)
    buf = ts.pack(tparams)
    assert buf.dtype == torch.float32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(js.pack(jparams)))
    back = ts.unpack(buf + 0.0)
    for (_, a), (_, b) in zip(tree_flatten_with_path(back)[0],
                              tree_flatten_with_path(tparams)[0]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    view = ts.leaf_view(buf, 0)
    assert view.shape == ts.shapes[0] and view.dtype == torch.float32


@pytest.mark.parametrize("n,p,r", [(0, 1, 1), (1, 1, 1), (1000, 1, 2),
                                   (131072, 8, 1), (1444864, 2, 3),
                                   (494147584, 1, 2), (494147584, 8, 2)])
def test_shard_geometry_equals_reference(n, p, r):
    assert tfb.shard_geometry(n, p, r) == jfb.shard_geometry(n, p, r)


@pytest.mark.parametrize("nbytes,rings,bucket", [(10, 1, None), (10, 2, None),
                                                 (1 << 30, 1, 1 << 26),
                                                 (1 << 30, 2, 1 << 20),
                                                 (5000, 3, 1000)])
def test_effective_rings_equals_reference(nbytes, rings, bucket):
    assert tfb.effective_rings(nbytes, rings, bucket) == \
        jfb.effective_rings(nbytes, rings, bucket)


def test_edge_grid_and_align_edge_equal_reference():
    assert tfb.edge_grid() == jfb.edge_grid()
    for n in (0, 1, 127, 128, 129, 16385):
        assert tfb.align_edge(n) == jfb.align_edge(n)
        assert tfb.align_edge(n, align=256) == jfb.align_edge(n, align=256)
    with pytest.raises(ValueError):
        tfb.align_edge(-1)


def test_pack_rejects_a_different_tree():
    ts = tfb.make_flatbuf({"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        ts.pack({"a": torch.zeros(3)})
