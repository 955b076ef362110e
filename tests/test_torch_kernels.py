"""The port's fused optimizer kernels (plain PyTorch versions, the CPU
path of each wrapper) held against the reference's Pallas kernels run in
interpret mode on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_optim import fused_optim as jfo  # noqa: E402
from repro.kernels.fused_sgd import fused_sgd as jfs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.fused_optim import fused_optim as tfo  # noqa: E402
from repro_torch.kernels.fused_sgd import fused_sgd as tfs  # noqa: E402

torch.set_num_threads(2)

SIZES = (1, 127, 128, 8193, 70000)


def _t(a):
    return params_from_numpy(a)


def _bf16_ulp_close(got, want):
    """|got - want| <= 1 bf16 ulp of ``want`` (both bf16, compared in f32)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    _, e = np.frexp(want)
    ulp = np.ldexp(np.float32(1.0), e - 8)  # 8 significant bits in bf16
    ulp = np.maximum(ulp, np.float32(2.0 ** -133))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


def _state(rng, n, dtype, positive=False):
    a = rng.standard_normal(n).astype(np.float32)
    a = np.abs(a) * 0.01 if positive else a * 0.1
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("n", SIZES)
def test_sgd_momentum_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    p, v, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    lr, mu = np.float32(0.1), np.float32(0.9)
    jp, jv = jfs.sgd_momentum_flat(jnp.asarray(p), jnp.asarray(v),
                                   jnp.asarray(g), lr, mu)
    before = tfs.sgd_momentum_flat.launches
    tp, tv = tfs.sgd_momentum_flat(_t(p), _t(v), _t(g),
                                   torch.tensor([lr, mu]))
    assert tfs.sgd_momentum_flat.launches == before  # CPU: no kernel launch
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_adagrad_plain_matches_pallas(n, state_dtype):
    rng = np.random.default_rng(1000 + n)
    p, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    s = _state(rng, n, state_dtype, positive=True)
    lr, eps = np.float32(0.01), np.float32(1e-10)
    jp, js = jfo.adagrad_flat(jnp.asarray(p), s, jnp.asarray(g), lr, eps)
    tp, ts = tfo.adagrad_flat(_t(p), _t(np.asarray(s)), _t(g),
                              torch.tensor([lr, eps]))
    assert ts.dtype == getattr(torch, state_dtype)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    if state_dtype == "float32":
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-7)
    else:
        _bf16_ulp_close(ts.float().numpy(), np.asarray(js))


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", (1, 127, 8193, 70000))
def test_adamw_plain_matches_pallas(n, state_dtype, t, wd):
    rng = np.random.default_rng(2000 + n)
    p, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    mv = jnp.stack([_state(rng, n, state_dtype),
                    _state(rng, n, state_dtype, positive=True)])
    lr, b1, b2, eps = (np.float32(x) for x in (3e-3, 0.9, 0.95, 1e-8))
    wd = np.float32(wd)
    c1 = np.float32(1) - b1 ** np.float32(t)
    c2 = np.float32(1) - b2 ** np.float32(t)
    jp, jmv = jfo.adamw_flat(jnp.asarray(p), mv, jnp.asarray(g),
                             lr, b1, b2, eps, wd, c1, c2)
    hp = torch.tensor([lr, b1, b2, eps, wd, c1, c2])
    tp, tmv = tfo.adamw_flat(_t(p), _t(np.asarray(mv)), _t(g), hp)
    assert tmv.shape == (2, n) and tmv.dtype == getattr(torch, state_dtype)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    if state_dtype == "float32":
        np.testing.assert_allclose(tmv.numpy(), np.asarray(jmv), rtol=1e-5,
                                   atol=1e-7)
    else:
        _bf16_ulp_close(tmv.float().numpy(), np.asarray(jmv))


def test_plain_versions_match_reference_oracles():
    """The plain versions also agree with the reference's ``ref.py``
    oracles (what the Pallas kernels are themselves tested against)."""
    from repro.kernels.fused_optim.ref import adagrad_ref, adamw_ref
    from repro.kernels.fused_sgd.ref import sgd_momentum_ref

    rng = np.random.default_rng(7)
    n = 4099
    p, v, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    s = np.abs(v)
    jp, jv = sgd_momentum_ref(jnp.asarray(p), jnp.asarray(v), jnp.asarray(g),
                              0.05, 0.9)
    tp, tv = tfs.sgd_momentum_flat(_t(p), _t(v), _t(g), torch.tensor([0.05, 0.9]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    jp, js = adagrad_ref(jnp.asarray(p), jnp.asarray(s), jnp.asarray(g), 0.01, 1e-10)
    tp, ts = tfo.adagrad_flat(_t(p), _t(s), _t(g), torch.tensor([0.01, 1e-10]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-7)
    m, vv = v * 0.1, s * 0.01
    jp, jm, jvv = adamw_ref(jnp.asarray(p), jnp.asarray(m), jnp.asarray(vv),
                            jnp.asarray(g), 3, 1e-3, 0.9, 0.95, 1e-8, 0.01)
    c1, c2 = (np.float32(1) - np.float32(b) ** np.float32(3) for b in (0.9, 0.95))
    hp = torch.tensor([1e-3, 0.9, 0.95, 1e-8, 0.01, c1, c2])
    tp, tmv = tfo.adamw_flat(_t(p), _t(np.stack([m, vv])), _t(g), hp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tmv[0].numpy(), np.asarray(jm), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tmv[1].numpy(), np.asarray(jvv), rtol=1e-5, atol=1e-7)


def test_layout_constants_match_reference():
    from repro.kernels import common as jcommon

    assert (common.LANE, common.SUBLANE) == (jcommon.LANE, jcommon.SUBLANE)
    for a, b in [(0, 1), (1, 1), (7, 3), (128, 128), (129, 128)]:
        assert common.ceil_div(a, b) == jcommon.ceil_div(a, b)


def test_dispatch_is_by_device_only():
    cpu = torch.zeros(3)
    assert common.on_cpu(cpu, cpu)
    with pytest.raises(ValueError, match="several devices"):
        common.on_cpu(cpu, torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        common.on_cpu(torch.zeros(3, device="meta"))
