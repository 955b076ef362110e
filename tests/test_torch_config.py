"""The port's config, policy, sync and data layers held against the
reference: same fields, same policy values, same validation verdicts, and
array-equal data batches."""
import dataclasses
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro.core import comm as jcomm, cost_model as jcost, hierarchy as jhier  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, TokenPipeline as JTokenPipeline  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import comm as tcomm, cost_model as tcost, hierarchy as thier  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402

torch.set_num_threads(2)

jsgd = importlib.import_module("repro.optim.sgd")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_qwen2_config_equals_reference(reduce):
    j, t = jbase.get_config("qwen2-0.5b"), tbase.get_config("qwen2-0.5b")
    if reduce:
        j, t = jbase.reduced(j), tbase.reduced(t)
    jf = _fields(j)
    for name, value in _fields(t).items():
        assert value == jf[name], name
    assert t.padded_vocab == j.padded_vocab
    assert t.resolved_head_dim == j.resolved_head_dim


DENSE = ["qwen2-0.5b", "qwen2.5-3b", "qwen3-4b", "phi3-medium-14b"]
FAMILIES = ["qwen2-moe-a2.7b", "mixtral-8x7b", "mamba2-130m", "zamba2-1.2b",
            "whisper-base", "paligemma-3b"]


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", DENSE[1:])
def test_dense_config_equals_reference(arch, reduce):
    """The three other dense configs field for field (and qwen2-0.5b's
    derived flags with them)."""
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    if reduce:
        j, t = jbase.reduced(j), tbase.reduced(t)
    jf = _fields(j)
    for name, value in _fields(t).items():
        assert value == jf[name], name
    assert t.padded_vocab == j.padded_vocab
    assert t.resolved_head_dim == j.resolved_head_dim
    for a, b in ((t, j), (tbase.get_config(DENSE[0]), jbase.get_config(DENSE[0]))):
        assert a.supports_long_decode == b.supports_long_decode
        assert a.is_attention_free == b.is_attention_free


@pytest.mark.parametrize("arch, count", [
    ("qwen2-0.5b", 494_146_560), ("qwen2.5-3b", 3_086_198_784),
    ("qwen3-4b", 4_412_067_840), ("phi3-medium-14b", 14_659_502_080)])
def test_param_counts_equal_reference(arch, count):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    assert t.param_count() == j.param_count() == count
    assert t.active_param_count() == j.active_param_count() == count
    assert tbase.reduced(t).param_count() == jbase.reduced(j).param_count()


def test_input_shapes_and_config_list_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    ported = tbase.list_configs()
    assert ported == jbase.list_configs()
    assert sorted(ported) == sorted(a.replace("-", "_").replace(".", "_")
                                    for a in DENSE + FAMILIES)
    for arch in ported:
        assert tbase.get_config(arch).citation == jbase.get_config(arch).citation


@pytest.mark.parametrize("kw", [
    dict(mode="dist", num_workers=12, num_clients=12, num_servers=2),
    dict(mode="mpi", num_workers=12, num_clients=2, num_servers=2),
    dict(mode="mpi", num_workers=8, num_clients=2, num_servers=0),
    dict(mode="mpi", num_workers=16, num_clients=4, num_servers=1, sync_every=8),
    dict(mode="dist", num_workers=4, num_clients=4, num_servers=3, sync_every=64),
])
@pytest.mark.parametrize("model_bytes", [1e8, 4 * 494_147_584])
def test_epoch_time_equals_reference(kw, model_bytes):
    common = dict(model_bytes=model_bytes, steps_per_epoch=100,
                  compute_time_per_step=0.5)
    want = jcost.epoch_time(net=jcost.testbed(), **common, **kw)
    got = tcost.epoch_time(net=tcost.testbed(), **common, **kw)
    assert got == want
    with pytest.raises(ValueError):
        tcost.epoch_time(net=tcost.testbed(), **common, **dict(kw, mode="nope"))


@pytest.mark.parametrize("v", [1, 255, 256, 1000, 151936])
def test_pad_vocab_equals_reference(v):
    assert tbase.pad_vocab(v) == jbase.pad_vocab(v)


@pytest.mark.parametrize("kw", [
    {}, dict(method="ring", num_rings=3), dict(method="psum", wire_dtype="int8"),
    dict(method="tree", wire_dtype="bf16"), dict(num_rings=0),
    dict(bucket_bytes=-1), dict(overlap=True), dict(overlap=True, method="ring"),
    dict(overlap=True, method="ring", num_rings=2), dict(method="nope"),
    dict(wire_dtype="fp8"), dict(overlap_buckets=0),
])
def test_policy_validate_verdicts_equal_reference(kw):
    jp, tp = jcomm.CollectivePolicy(**kw), tcomm.CollectivePolicy(**kw)
    assert tp.to_dict() == jp.to_dict()
    assert tcomm.CollectivePolicy.from_dict(tp.to_dict()) == tp

    def verdict(p):
        try:
            p.validate()
            return None
        except ValueError as e:
            return str(e)

    assert verdict(tp) == verdict(jp)


def test_policy_from_dict_rejects_unknown():
    with pytest.raises(ValueError, match="unknown"):
        tcomm.CollectivePolicy.from_dict({"rings": 2})


@pytest.mark.parametrize("kw", [
    {}, dict(policy=jcomm.CollectivePolicy(method="ring", num_rings=1)),
    dict(allreduce_method="ring", wire_dtype="bf16"), dict(num_rings=4),
    dict(fused_update=False), dict(bucket_bytes=1 << 20),
])
def test_sync_config_mirrors_equal_reference(kw):
    tkw = dict(kw)
    if "policy" in kw:
        tkw["policy"] = tcomm.CollectivePolicy(**kw["policy"].to_dict())
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jhier.SyncConfig(**kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = thier.SyncConfig(**tkw)
    assert t.policy.to_dict() == j.policy.to_dict()
    assert (t.allreduce_method, t.num_rings, t.bucket_bytes, t.wire_dtype) == \
        (j.allreduce_method, j.num_rings, j.bucket_bytes, j.wire_dtype)
    assert len([w for w in tw if w.category is DeprecationWarning]) == \
        len([w for w in jw if w.category is DeprecationWarning])
    # replace() round trips keep the policy and stay quiet
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dataclasses.replace(t, mode="mpi_sgd").policy == t.policy
    t.validate()


def test_sync_config_validate_rejects_like_reference():
    for kw in (dict(mode="dist_sgd"),
               dict(policy=jcomm.CollectivePolicy(method="psum", wire_dtype="int8"))):
        tkw = dict(kw)
        if "policy" in kw:
            tkw["policy"] = tcomm.CollectivePolicy(**kw["policy"].to_dict())
        with pytest.raises(ValueError):
            jhier.SyncConfig(**kw).validate()
        with pytest.raises(ValueError):
            thier.SyncConfig(**tkw).validate()


@pytest.mark.parametrize("name", ["sgd", "adamw", "adagrad"])
@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_train_settings_lower_like_reference(name, state_dtype):
    kw = dict(lr=0.01, optimizer_name=name, state_dtype=state_dtype)
    j, t = jbase.TrainSettings(**kw), tbase.TrainSettings(**kw)
    assert t.policy.to_dict() == j.policy.to_dict()
    assert t.sync_config().policy.to_dict() == j.sync_config().policy.to_dict()
    jh, th = dict(j.optimizer().hyper), dict(t.optimizer().hyper)
    jsd, tsd = jh.pop("state_dtype"), th.pop("state_dtype")
    assert th == jh
    assert (tsd is None) == (jsd is None)
    if tsd is not None:
        assert str(tsd).replace("torch.", "") == str(np.dtype(jsd))


def test_train_settings_reject_like_reference():
    for kw in (dict(optimizer_name="adagrad", weight_decay=0.1),
               dict(optimizer_name="lion"), dict(state_dtype="f16")):
        with pytest.raises(ValueError):
            jbase.TrainSettings(**kw).optimizer()
        with pytest.raises(ValueError):
            tbase.TrainSettings(**kw).optimizer()


def test_local_communicator_and_unported_groups():
    local = tcomm.LOCAL
    assert local.resolve_size() == 1
    assert local.rings_for(1 << 20) == jcomm.LOCAL.rings_for(1 << 20)
    wide = local.with_policy(num_rings=2, bucket_bytes=1000)
    assert wide.rings_for(10_000) == \
        jcomm.LOCAL.with_policy(num_rings=2, bucket_bytes=1000).rings_for(10_000)
    assert wide.local() == wide
    assert tcomm.from_sync(thier.SyncConfig()).policy == thier.SyncConfig().policy
    # a group of size > 1 is the emulated ring world now; its tensor
    # collectives run on stacked trees, and it re-splits as the reference's
    world = tcomm.Communicator.world(("data",), (8,))
    assert world.resolve_size() == 8 and world.local().resolve_size() == 1
    assert world.resized(4).sizes == jcomm.Communicator.world(("data",), (8,)).resized(4).sizes
    assert world.resized(4).resolve_size() == 4 and world.resized(4).policy == world.policy
    stacked = {"w": torch.arange(8.0).repeat_interleave(3).reshape(8, 3)}
    mean = world.pushpull(stacked)["w"]
    assert tuple(mean.shape) == (8, 3) and torch.equal(mean, torch.full((8, 3), 3.5))
    params = {"w": torch.zeros(2)}
    assert thier.clientize(params, 1) is params
    assert tuple(thier.clientize(params, 2)["w"].shape) == (2, 2)


@pytest.mark.parametrize("epoch,step,shard", [(0, 0, 0), (0, 7, 0), (3, 2, 1)])
def test_token_batches_equal_reference(epoch, step, shard):
    kw = dict(seed=5, vocab_size=256, seq_len=33, batch_size=4, shard=shard)
    want = JTokenPipeline(JDataConfig(**kw)).batch_at(epoch, step)
    got = TokenPipeline(DataConfig(**kw)).batch_at(epoch, step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_token_pipeline_epoch_and_floor_equal_reference():
    kw = dict(seed=0, vocab_size=64, seq_len=8, batch_size=2, steps_per_epoch=3)
    jp, tp = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(DataConfig(**kw))
    for jb, tb in zip(jp.epoch(1), tp.epoch(1)):
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
    assert len(list(tp.epoch(0))) == 3
    assert tp.optimal_xent() == pytest.approx(jp.optimal_xent(), rel=1e-6)
