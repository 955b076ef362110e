"""The port's ResNet, ``ImagePipeline`` and six-mode example against the
reference (``repro/models/resnet.py``, ``repro/data/pipeline.py``,
``examples/hybrid_ps_mpi.py``) on bridged weights, on the CPU.

Tolerances:
- ``ImagePipeline`` batches byte-equal (numpy draws as the reference's);
- ``_conv`` against ``lax.conv_general_dilated(..., "SAME")`` and the
  forward / loss: rtol 1e-5 / atol 1e-6 (f32, the same products summed in
  other orders), at 16 px, at the example's 8 px (even: a stride-2
  ``"SAME"`` conv pads (0, 1)) and at 7 px (odd: (1, 1));
- grads: rtol 1e-4 of each entry or of the leaf's largest;
- the six modes through ``algorithms.run``: the simulated clock exactly
  equal, losses rtol 1e-4, accuracies within one test sample (1/256).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.resnet50_cifar import CONFIG as JCONFIG  # noqa: E402
from repro.core import algorithms as JA, flatbuf as jflatbuf  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, ImagePipeline as JImagePipeline  # noqa: E402
from repro.data.pipeline import shard_config as jshard_config  # noqa: E402
from repro.models import resnet as jr  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.resnet50_cifar import CONFIG, ResNetConfig  # noqa: E402
from repro_torch.core import flatbuf  # noqa: E402
from repro_torch.core.comm import CollectivePolicy as TCollectivePolicy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, ImagePipeline, shard_config  # noqa: E402
from repro_torch.launch import hybrid_ps_mpi as hyb  # noqa: E402
from repro_torch.models import resnet as tr  # noqa: E402
from repro_torch.tree import path_str, tree_flatten_with_path  # noqa: E402

torch.set_num_threads(2)

#: the configs held: the default (16 px), the example's (8 px, even) and
#: the example's at 7 px (odd); the paper-scale layout for the trees only
CFGS = {"default": {}, "example-8px": dict(stage_sizes=(1, 1), width=8, image_size=8),
        "example-7px": dict(stage_sizes=(1, 1), width=8, image_size=7)}
PAPER = dict(stage_sizes=(3, 4, 6, 3), width=64, num_classes=1000, image_size=224)
#: examples/hybrid_ps_mpi.py's AlgoConfig but for the mode and the epochs
EXAMPLE_ALGO = dict(num_workers=4, num_clients=2, num_servers=1, lr=0.1, momentum=0.9,
                    steps_per_epoch=10, esgd_interval=4, compute_time=0.45, jitter=0.2,
                    model_bytes=1e8)


def _cfgs(kw):
    return dataclasses.replace(JCONFIG, **kw), dataclasses.replace(CONFIG, **kw)


def _bridged(kw, seed=0):
    """One set of weights for both (numpy for the reference, tensors for
    the port): the port's init from ``seed`` (its tree is the reference's,
    ``test_param_tree_and_flatbuffer_equal_reference``) with the GroupNorm
    scales and biases moved off 1 / 0."""
    jc, tc = _cfgs(kw)
    jp = params_to_numpy(tr.init_resnet(torch.Generator().manual_seed(seed), tc, "cpu"))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
                      if a.ndim == 1 else a, jp)
    return jc, tc, jp, params_from_numpy(jp)


def _batch(jc, B=8, seed=0):
    b = JImagePipeline(JDataConfig(seed=seed, batch_size=B),
                       image_size=jc.image_size, num_classes=jc.num_classes).batch_at(0, 0)
    b = {k: np.asarray(v) for k, v in b.items()}
    return b, {k: torch.from_numpy(v.copy()) for k, v in b.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("image_size, classes", [(8, 10), (7, 10), (16, 1000)])
@pytest.mark.parametrize("epoch, step, shard", [(0, 0, 0), (1, 3, 2), (99, 0, 999)])
def test_image_pipeline_batches_byte_equal_reference(image_size, classes, epoch, step, shard):
    cfg = dict(seed=3, batch_size=5, steps_per_epoch=4, shard=shard)
    want = JImagePipeline(JDataConfig(**cfg), image_size=image_size,
                          num_classes=classes).batch_at(epoch, step)
    got = ImagePipeline(DataConfig(**cfg), image_size=image_size,
                        num_classes=classes).batch_at(epoch, step)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == getattr(torch, str(w.dtype)) and got[k].device.type == "cpu"
        assert got[k].numpy().tobytes() == w.tobytes(), k


def test_image_pipeline_epoch_and_shard_config_equal_reference():
    j = jshard_config(JDataConfig(batch_size=2, steps_per_epoch=3), 4, 1)
    t = shard_config(DataConfig(batch_size=2, steps_per_epoch=3), 4, 1)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jb = list(JImagePipeline(j, image_size=4).epoch(2))
    tb = list(ImagePipeline(t, image_size=4).epoch(2))
    assert len(tb) == len(jb) == 3
    for a, b in zip(jb, tb):
        assert b["images"].numpy().tobytes() == np.asarray(a["images"]).tobytes()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [7, 8, 16])
@pytest.mark.parametrize("k, stride", [(3, 1), (3, 2), (1, 2), (1, 1)])
def test_conv_same_padding_matches_reference(size, k, stride):
    """``"SAME"`` as XLA pads it: the extra row low-side-last, so a 3x3
    stride-2 conv of an even input pads (0, 1)."""
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = np.asarray(jr._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tr._conv(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if k == 3 and stride == 2 and size % 2 == 0:
        # the trap: symmetric padding shifts every downsampled map a pixel
        naive = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
            stride=2, padding=1).permute(0, 2, 3, 1).numpy()
        assert np.abs(naive - want).max() > 1.0


@pytest.mark.parametrize("C", [3, 8, 16, 64])
def test_group_norm_matches_reference(C):
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((2, 5, 5, C)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal(C).astype(np.float32), rng.standard_normal(C).astype(np.float32)
    want = np.asarray(jr._gn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tr._gn(*(torch.from_numpy(a) for a in (x, s, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", list(CFGS) + ["paper"])
def test_param_tree_and_flatbuffer_equal_reference(which):
    """Paths (sorted keys, the ``blocks`` list), shapes, dtypes and the
    FlatBuffer layout; the block plan; init's scales."""
    kw = PAPER if which == "paper" else CFGS[which]
    jc, tc = _cfgs(kw)
    jabs = jax.eval_shape(lambda k: jr.init_resnet(k, jc), jax.random.key(0))
    tp = tr.init_resnet(torch.Generator().manual_seed(0), tc, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jabs)[0]
    tl = tree_flatten_with_path(tp)[0]
    jpath = lambda p: "/".join(f"k:{e.key}" if hasattr(e, "key") else f"i:{e.idx}"
                               for e in p)
    assert [path_str(p) for p, _ in tl] == [jpath(p) for p, _ in jl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
    js, ts = jflatbuf.spec_for(jabs), flatbuf.spec_for(tp)
    assert (ts.offsets, ts.sizes, ts.size, ts.payload) == (js.offsets, js.sizes, js.size,
                                                            js.payload)
    assert tr._block_plan(tc) == jr._block_plan(jc)
    if which == "paper":
        # ResNet-34's stage layout under the reference's basic GN block
        assert ts.payload == 21_788_200
        return
    # the reference's init scales: He-normal convs, N(0, 0.01²) head
    want_std = {"stem": (2 / 27) ** 0.5, "head": 0.01}
    for key, std in want_std.items():
        assert abs(float(tp[key].std()) / std - 1) < 0.2
    assert torch.equal(tp["stem_s"], torch.ones(tc.width))


def test_init_is_the_same_on_every_device_from_a_seed():
    """Drawn on the generator's device, so a CPU generator gives the card
    and the CPU the same weights (``algorithms.run`` passes one)."""
    cfg = ResNetConfig(**CFGS["example-8px"])
    a = tr.init_resnet(torch.Generator().manual_seed(5), cfg, "cpu")
    b = tr.init_resnet(torch.Generator().manual_seed(5), cfg, torch.device("cpu"))
    for x, y in zip(jax.tree.leaves(params_to_numpy(a)), jax.tree.leaves(params_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


def test_bridge_round_trips_blocks_with_and_without_proj():
    jc, tc, jp, tp = _bridged(CFGS["default"])
    assert ["proj" in b for b in jp["blocks"]] == [False, True, True]
    jc, tc, jp, tp = _bridged(dict(stage_sizes=(2, 1), width=8, image_size=8))
    assert ["proj" in b for b in tp["blocks"]] == [False, False, True]
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("which", list(CFGS))
def test_forward_and_loss_match_reference(which):
    jc, tc, jp, tp = _bridged(CFGS[which])
    jb, tb = _batch(jc)
    want = np.asarray(jax.jit(lambda p, x: jr.resnet_apply(p, x, jc))(jp, jb["images"]))
    with torch.no_grad():
        got = tr.resnet_apply(tp, tb["images"], tc).numpy()
        loss, met = tr.resnet_loss(tp, tb, tc)
    assert got.shape == (8, jc.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jloss, jmet = jax.jit(lambda p, b: jr.resnet_loss(p, b, jc))(jp, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert float(met["acc"]) == float(jmet["acc"])


@pytest.mark.parametrize("which", list(CFGS))
def test_grads_match_reference(which):
    jc, tc, jp, tp = _bridged(CFGS[which])
    jb, tb = _batch(jc, seed=1)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p, b: jr.resnet_loss(p, b, jc)[0]))(jp, jb)
    loss, grads = hyb.make_grad_fn(tc)(tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = jax.tree.leaves(params_to_numpy(grads))
    assert len(got) == len(jax.tree.leaves(jg))
    for (path, want), have in zip(jax.tree_util.tree_flatten_with_path(jg)[0], got):
        want = np.asarray(want)
        np.testing.assert_allclose(have, want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the six modes (examples/hybrid_ps_mpi.py)
# ---------------------------------------------------------------------------

class _Example:
    """The reference example's pieces (``jax.jit`` grad, held-out
    accuracy, per-worker pipelines) at 2 epochs of 4 steps, and the
    bridged weights both runs start from."""

    STEPS = 4

    def __init__(self):
        self.jc, self.tc, self.p0, _ = _bridged(CFGS["example-8px"], seed=2)
        jc = self.jc
        self.jgrad = jax.jit(jax.value_and_grad(lambda p, b: jr.resnet_loss(p, b, jc)[0]))
        tb = JImagePipeline(JDataConfig(seed=0, batch_size=256, steps_per_epoch=1,
                                        shard=999), image_size=8).batch_at(99, 0)
        logits = jax.jit(lambda p: jr.resnet_apply(p, tb["images"], jc))
        self.jeval = lambda p: float(jnp.mean(
            (jnp.argmax(logits(p), -1) == tb["labels"]).astype(jnp.float32)))

    def run_both(self, mode, wire):
        kw = dict(epochs=2, steps_per_epoch=self.STEPS)
        jpol = tpol = {}
        if wire:
            jpol = {"policy": JA.CollectivePolicy(method="multi_ring", num_rings=2,
                                                  wire_dtype=wire)}
            tpol = {"policy": TCollectivePolicy(method="multi_ring", num_rings=2,
                                                wire_dtype=wire)}
        jh = JA.run(JA.AlgoConfig(mode=mode, **{**EXAMPLE_ALGO, **kw}, **jpol),
                    lambda key: jax.tree.map(jnp.asarray, self.p0), self.jgrad,
                    self.jeval, lambda w: JImagePipeline(JDataConfig(
                        seed=0, batch_size=8, steps_per_epoch=self.STEPS, shard=w),
                        image_size=8))
        th = hyb.run_example(hyb.example_config(mode, **kw, **tpol), "cpu",
                             init_fn=lambda gen: params_from_numpy(self.p0))
        return jh, th


@pytest.fixture(scope="module")
def example():
    return _Example()


@pytest.mark.parametrize("mode, wire", [(m, None) for m in JA.MODES] + [("mpi_esgd", "int8")])
def test_six_modes_match_reference(example, mode, wire):
    jh, th = example.run_both(mode, wire)
    for f in ("times", "epochs", "epoch_time", "mean_staleness", "live_clients",
              "degraded_syncs", "late_pushes"):
        assert getattr(th, f) == getattr(jh, f), f
    np.testing.assert_allclose(th.losses, jh.losses, rtol=1e-4)
    assert len(th.metrics) == len(jh.metrics)
    np.testing.assert_allclose(th.metrics, jh.metrics, rtol=0, atol=1 / 256 + 1e-9)


def test_example_config_is_the_examples():
    for mode in JA.MODES:
        got = hyb.example_config(mode, epochs=3)
        want = JA.AlgoConfig(mode=mode, epochs=3, **EXAMPLE_ALGO)
        for f in dataclasses.fields(want):
            if f.name not in ("net", "policy_src"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.policy.method == want.policy.method == "multi_ring"
    assert hyb.EXAMPLE == ResNetConfig(stage_sizes=(1, 1), width=8, image_size=8)


def test_example_main_runs_every_mode_on_the_cpu(capsys):
    out = hyb.main(["--device", "cpu", "--epochs", "1"])
    assert list(out) == list(JA.MODES)
    for h in out.values():
        assert len(h.metrics) == 1 and 0.0 <= h.metrics[0] <= 1.0
        assert all(np.isfinite(h.losses))
    text = capsys.readouterr().out
    assert text.splitlines()[0].split() == ["mode", "final_acc", "epoch_time", "staleness"]
    assert len(text.splitlines()) == 7


def test_example_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hyb.main(["--epochs", "1"])
