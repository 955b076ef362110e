"""The port's fused elastic kernels (plain PyTorch versions, the CPU path
of each wrapper) held against the reference's Pallas kernels run in
interpret mode on the same numpy inputs.

Tolerances: f32 outputs exactly equal for ``elastic_exchange_flat``,
``elastic_client_flat``, ``elastic_server_flat``,
``elastic_client_diff_flat``,
``elastic_center_flat`` and ``elastic_exchange_flat_mc`` at C <= 2, and
for the packed one-sided forms ``elastic_client_packed`` /
``elastic_server_packed`` on a whole tree (the reference compiles eqs.
(2)/(3) into one fused multiply-add, and the plain versions round once
too);
rtol 1e-6 for the center at C = 4, because the reference's sum over the
C rows is an XLA reduction whose order is not fixed (the port sums
c = 0 … C-1); bf16 outputs within 1 bf16 ulp. The one-pair packed
exchange ``elastic_exchange_packed`` and the per-leaf
``elastic_exchange_fused`` are exact at f32 and over the bf16 wire. Over
the int8 wire the new w is exact and each element of the new center
within 2 (α · ulp(decoded w) + ulp(w̃')) of the reference's: the
reference's jitted packed exchange fuses the streaming decode into the
exchange, so its center output is ``fma(α, fma(code, scale, −w̃), w̃)``,
the decoded value never rounded before the difference (1.3 % to 9 % of
the elements differ, by tree), while its new w takes the decoded value
rounded, as the port's two kernels do."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import elastic as jel  # noqa: E402
from repro.kernels.fused_elastic import fused_elastic as jfe  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import elastic as tel  # noqa: E402
from repro_torch.kernels.fused_elastic import fused_elastic as tfe  # noqa: E402

torch.set_num_threads(2)

SIZES = (1000, 4099, 131072)
DTYPES = ("float32", "bfloat16")
ALPHA = np.float32(0.5 / 3)


def _t(a):
    return params_from_numpy(np.asarray(a))


def _alpha():
    return torch.tensor(ALPHA, dtype=torch.float32)


def _check(got, want, *, rtol=0.0):
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16
        g, w = got.float().numpy(), want.astype(np.float32)
        _, e = np.frexp(w)
        ulp = np.maximum(np.ldexp(np.float32(1.0), e - 8), np.float32(2.0 ** -133))
        assert np.all(np.abs(g - w) <= ulp)
    elif rtol:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def _wc(rng, shape, dtype):
    w = rng.standard_normal(shape).astype(np.float32)
    c = (w.reshape(-1, shape[-1])[0] + 0.1 * rng.standard_normal(shape[-1])
         ).astype(np.float32)
    return jnp.asarray(w).astype(dtype), jnp.asarray(c).astype(dtype)


@pytest.mark.parametrize("side", ["client", "server"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_one_side_plain_matches_pallas(n, dtype, side):
    """Eq. (3) alone (new w in w's dtype) and eq. (2) alone (new w̃ in
    w̃'s dtype), at α = 0.5/3 where a separate product and sum would
    round differently from the fused form on ~9 % of the elements."""
    w, c = _wc(np.random.default_rng(30 + n), (n,), dtype)
    jfn = getattr(jfe, f"elastic_{side}_flat")
    tfn = getattr(tfe, f"elastic_{side}_flat")
    want = jfn(w, c, ALPHA)
    before = tfn.launches
    got = tfn(_t(w), _t(c), _alpha())
    assert tfn.launches == before  # CPU: no launch
    assert got.dtype == _t(w).dtype and tuple(got.shape) == (n,)
    _check(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_one_side_matches_reference(dtype):
    """``elastic_client_packed`` / ``elastic_server_packed`` on a tree of
    ragged leaves: pack, one fused pass, unpack — equal to the
    reference's jitted forms leaf by leaf."""
    rng = np.random.default_rng(40)
    shapes = {"a": (3, 50), "b": {"c": (129,), "d": (7, 11, 2)}}

    def tree(scale):
        return jax.tree.map(
            lambda s: jnp.asarray(scale * rng.standard_normal(s).astype(np.float32)
                                  ).astype(dtype),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    w, c = tree(1.0), tree(0.5)
    alpha = float(ALPHA)
    for name, args in (("client", (w, c)), ("server", (w, c))):
        want = getattr(jel, f"elastic_{name}_packed")(*args, alpha)
        got = getattr(tel, f"elastic_{name}_packed")(
            *(params_from_numpy(jax.tree.map(np.asarray, a)) for a in args), alpha)
        got = jax.tree.leaves(params_to_numpy(got))
        for g, wnt in zip(got, jax.tree.leaves(want)):
            _check(params_from_numpy(g), wnt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_client_diff_plain_matches_pallas(n, dtype):
    w, c = _wc(np.random.default_rng(n), (n,), dtype)
    jw, jd = jfe.elastic_client_diff_flat(w, c, ALPHA)
    before = tfe.elastic_client_diff_flat.launches
    tw, td = tfe.elastic_client_diff_flat(_t(w), _t(c), _alpha())
    assert tfe.elastic_client_diff_flat.launches == before  # CPU: no launch
    assert td.dtype == torch.float32 and tw.dtype == _t(w).dtype
    _check(tw, jw)
    _check(td, jd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_center_plain_matches_pallas(n, dtype):
    rng = np.random.default_rng(10 + n)
    c = jnp.asarray(rng.standard_normal(n).astype(np.float32)).astype(dtype)
    ds = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    want = jfe.elastic_center_flat(c, ds, ALPHA)
    before = tfe.elastic_center_flat.launches
    got = tfe.elastic_center_flat(_t(c), _t(ds), _alpha())
    assert tfe.elastic_center_flat.launches == before
    _check(got, want)


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_multiclient_plain_matches_pallas(n, dtype, C):
    w, c = _wc(np.random.default_rng(20 + n + C), (C, n), dtype)
    alpha = np.float32(0.5 / C)
    jw, jc = jfe.elastic_exchange_flat_mc(w, c, alpha)
    before = tfe.elastic_exchange_flat_mc.launches
    tw, tc = tfe.elastic_exchange_flat_mc(_t(w), _t(c),
                                          torch.tensor(alpha, dtype=torch.float32))
    assert tfe.elastic_exchange_flat_mc.launches == before
    _check(tw, jw)
    _check(tc, jc, rtol=1e-6 if (C > 2 and dtype == "float32") else 0.0)


def test_stacked_rows_are_one_call():
    """A stacked (rows, n) buffer runs as one flat pass: the same values
    as the rows one by one."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((3, 500)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((3, 500)).astype(np.float32))
    nw, d = tfe.elastic_client_diff_flat(w, c, _alpha())
    for i in range(3):
        rw, rd = tfe.elastic_client_diff_flat(w[i], c[i], _alpha())
        assert torch.equal(nw[i], rw) and torch.equal(d[i], rd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_exchange_plain_matches_pallas(n, dtype):
    """Eqs. (3) and (2) from one difference, both outputs one fused
    multiply-add each: w' = fma(−α, w − w̃, w), w̃' = fma(α, w − w̃, w̃)."""
    w, c = _wc(np.random.default_rng(70 + n), (n,), dtype)
    jw, jc = jfe.elastic_exchange_flat(w, c, jnp.asarray(ALPHA).reshape(1))
    before = tfe.elastic_exchange_flat.launches
    tw, tc = tfe.elastic_exchange_flat(_t(w), _t(c), _alpha())
    assert tfe.elastic_exchange_flat.launches == before   # CPU: no launch
    _check(tw, jw)
    _check(tc, jc)


def _exchange_trees(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 50), "b": {"c": (129,), "d": (7, 11, 2)}, "e": (1000,)}

    def tree():
        return jax.tree.map(
            lambda s: jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(dtype),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    w = tree()
    c = jax.tree.map(lambda l: (l.astype(jnp.float32) + 0.1).astype(dtype), tree())
    return w, c


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_exchange_packed_matches_reference(dtype, wire):
    """``elastic_exchange_packed`` on a tree of ragged leaves (w first
    through the PS wire), and the per-leaf ``elastic_exchange_fused``,
    against the reference's jitted forms."""
    from repro.kernels.fused_elastic.ops import elastic_exchange_fused as jfused
    from repro_torch.kernels.fused_elastic.ops import elastic_exchange_fused as tfused

    w, c = _exchange_trees(dtype, 80)
    alpha = float(ALPHA)
    jw, jc = jel.elastic_exchange_packed(w, c, alpha, wire_dtype=wire)
    tw, tc = tel.elastic_exchange_packed(
        *(params_from_numpy(jax.tree.map(np.asarray, a)) for a in (w, c)), alpha,
        wire_dtype=wire)
    for g, want in zip(jax.tree.leaves(params_to_numpy(tw)), jax.tree.leaves(jw)):
        _check(params_from_numpy(g), want)
    decoded = jax.tree.leaves(params_to_numpy(tel.wire_packed(
        params_from_numpy(jax.tree.map(np.asarray, w)), wire)))
    for g, want, wd in zip(jax.tree.leaves(params_to_numpy(tc)), jax.tree.leaves(jc),
                           decoded):
        if wire == "int8" and dtype == "float32":
            # α times the rounding of the decoded w, then the result's own
            # rounding, each counted twice
            want32 = np.abs(np.asarray(want)).astype(np.float32)
            bound = 2 * (np.float32(ALPHA) * np.spacing(np.abs(wd).astype(np.float32))
                         + np.spacing(want32))
            np.testing.assert_array_less(np.abs(g - np.asarray(want)), bound + 1e-30)
        else:
            _check(params_from_numpy(g), want)
    if wire is None:
        a32 = jnp.asarray(ALPHA)
        jw, jc = jfused(w, c, a32)
        tw, tc = tfused(*(params_from_numpy(jax.tree.map(np.asarray, a)) for a in (w, c)),
                        _alpha())
        for got, want in ((tw, jw), (tc, jc)):
            for g, wnt in zip(jax.tree.leaves(params_to_numpy(got)),
                              jax.tree.leaves(want)):
                _check(params_from_numpy(g), wnt)


def test_exchange_packed_removed_aliases_raise_as_reference():
    w, c = _exchange_trees("float32", 81)
    tw, tc = (params_from_numpy(jax.tree.map(np.asarray, a)) for a in (w, c))
    for mod, args in ((jel, (w, c)), (tel, (tw, tc))):
        with pytest.raises(ValueError, match="wire_dtype='int8'"):
            mod.elastic_exchange_packed(*args, 0.5, compress=True)
        with pytest.raises(ValueError, match="wire_packed"):
            mod.quantize_packed(args[0])
