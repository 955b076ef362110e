"""Card-only checks of the port: each kernel (Triton, or CUDA C++ built
from ``src/repro_torch/csrc``) against its plain PyTorch version on the
same CUDA tensors, and the reduced train step on the card against the
same step on the CPU.

These need a CUDA device and skip without one. This module imports no
JAX, so on a machine without it run it with the repo's conftest off:

  python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_elastic import fused_elastic as fe  # noqa: E402
from repro_torch.kernels.fused_optim import fused_optim as fo  # noqa: E402
from repro_torch.kernels.fused_sgd import fused_sgd as fs  # noqa: E402
from repro_torch.kernels.quant_bucket import quant_bucket as qb  # noqa: E402
from repro_torch.kernels.tensor_reduce import tensor_reduce as tr  # noqa: E402

SIZES = (1, 127, 128, 4097, 70000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_within_one_ulp(got, want, atol=1e-7):
    """Within 1 bf16 ulp beyond the f32 tolerance of the value before
    rounding: FMA contraction in the kernel moves a result that cancels to
    near zero by up to ``atol``, which can be many bf16 ulps of it."""
    got, want = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    ulp = torch.clamp(ulp, min=2.0 ** -133)
    assert bool(torch.all((got - want).abs() <= ulp + atol))


def _inputs(n, device, state_dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda: torch.randn(n, generator=gen, device=device)
    return r(), r(), (r().abs() * 0.01).to(state_dtype), (r() * 0.1).to(state_dtype)


@pytest.mark.parametrize("n", SIZES)
def test_sgd_kernel_matches_plain(cuda, n):
    p, g, _, v = _inputs(n, cuda, torch.float32, n)
    hp = torch.tensor([0.1, 0.9], device=cuda)
    before = fs.sgd_momentum_flat.launches
    kp, kv = fs.sgd_momentum_flat(p, v, g, hp)
    torch.cuda.synchronize()
    assert fs.sgd_momentum_flat.launches == before + 1
    rp, rv = fs.sgd_momentum_flat_plain(p, v, g, hp)
    torch.testing.assert_close(kp, rp, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(kv, rv, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", SIZES)
def test_adagrad_kernel_matches_plain(cuda, n, state_dtype):
    p, g, s, _ = _inputs(n, cuda, state_dtype, 10 + n)
    hp = torch.tensor([0.01, 1e-10], device=cuda)
    before = fo.adagrad_flat.launches
    kp, ks = fo.adagrad_flat(p, s, g, hp)
    torch.cuda.synchronize()
    assert fo.adagrad_flat.launches == before + 1
    rp, rs = fo.adagrad_flat_plain(p, s, g, hp)
    torch.testing.assert_close(kp, rp, rtol=1e-5, atol=1e-7)
    if state_dtype == torch.float32:
        torch.testing.assert_close(ks, rs, rtol=1e-5, atol=1e-7)
    else:
        _bf16_within_one_ulp(ks, rs)


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", SIZES)
def test_adamw_kernel_matches_plain(cuda, n, state_dtype):
    p, g, v, m = _inputs(n, cuda, state_dtype, 20 + n)
    mv = torch.stack([m, v])
    t = 3
    c1, c2 = 1 - 0.9 ** t, 1 - 0.95 ** t
    hp = torch.tensor([3e-3, 0.9, 0.95, 1e-8, 0.1, c1, c2], device=cuda)
    before = fo.adamw_flat.launches
    kp, kmv = fo.adamw_flat(p, mv, g, hp)
    torch.cuda.synchronize()
    assert fo.adamw_flat.launches == before + 1
    rp, rmv = fo.adamw_flat_plain(p, mv, g, hp)
    torch.testing.assert_close(kp, rp, rtol=1e-5, atol=1e-7)
    if state_dtype == torch.float32:
        torch.testing.assert_close(kmv, rmv, rtol=1e-5, atol=1e-7)
    else:
        _bf16_within_one_ulp(kmv, rmv)


def test_adamw_kernel_stacked_rows_match_plain(cuda):
    """(R, n) params and (R, 2, n) m/v under one hp vector: one launch
    over every row, the ragged tail of each row masked."""
    R, n = 3, 4099
    gen = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *shape: torch.randn(*shape, generator=gen, device=cuda)
    p, g = r(R, n), r(R, n)
    mv = torch.stack([r(R, n) * 0.1, r(R, n).abs() * 0.01], 1)
    base = torch.tensor([3e-3, 0.9, 0.95, 1e-8, 0.1], device=cuda)
    hp = torch.cat([base, 1 - base[1:3] ** 7])
    before = fo.adamw_flat.launches
    kp, kmv = fo.adamw_flat(p, mv, g, hp)
    torch.cuda.synchronize()
    assert fo.adamw_flat.launches == before + 1
    rp, rmv = fo.adamw_flat_plain(p, mv, g, hp)
    torch.testing.assert_close(kp, rp, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(kmv, rmv, rtol=1e-5, atol=1e-7)


def _elastic_inputs(shape, device, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, generator=gen, device=device)
    c = w.reshape(-1, shape[-1])[0] + 0.1 * torch.randn(
        shape[-1], generator=gen, device=device)
    return w.to(dtype), c.to(dtype)


ELASTIC_SIZES = (1, 1000, 4099, 131072)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", ELASTIC_SIZES)
def test_elastic_client_diff_kernel_matches_plain(cuda, n, dtype):
    w, c = _elastic_inputs((n,), cuda, dtype, n)
    alpha = torch.tensor(0.25, device=cuda)
    before = fe.elastic_client_diff_flat.launches
    kw, kd = fe.elastic_client_diff_flat(w, c, alpha)
    torch.cuda.synchronize()
    assert fe.elastic_client_diff_flat.launches == before + 1
    rw, rd = fe.elastic_client_diff_flat_plain(w, c, alpha)
    assert kd.dtype == torch.float32 and kw.dtype == dtype
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(kw, rw, rtol=1e-6, atol=1e-7)
    else:
        _bf16_within_one_ulp(kw, rw)


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", ELASTIC_SIZES)
def test_elastic_multiclient_kernel_matches_plain(cuda, n, dtype, C):
    w, c = _elastic_inputs((C, n), cuda, dtype, 90 + n + C)
    alpha = torch.tensor(0.5 / C, device=cuda)
    before = fe.elastic_exchange_flat_mc.launches
    kw, kc = fe.elastic_exchange_flat_mc(w, c, alpha)
    torch.cuda.synchronize()
    assert fe.elastic_exchange_flat_mc.launches == before + 1
    rw, rc = fe.elastic_exchange_flat_mc_plain(w, c, alpha)
    for got, want in ((kw, rw), (kc, rc)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        else:
            _bf16_within_one_ulp(got, want)


WIRE_SIZES = (1, 127, 8191, 8192, 8193, 3 * 8192, 100_003)


def _wire_values(n, device, dtype):
    """Normal values, one all-zero bucket, and one bucket of ±k.5 at scale
    1 (every code a tie that rounds half to even)."""
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn(n, generator=gen, device=device)
    if n >= 256:
        x[:128] = 0.0
        x[128] = 127.0
        x[129:256] = torch.arange(-63, 64, device=device) + 0.5
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", WIRE_SIZES)
def test_quantize_wire_kernel_matches_plain(cuda, n, dtype):
    """Codes and scales equal the plain version's over the whole padded
    arrays (ragged n and whole tiles alike)."""
    x = _wire_values(n, cuda, dtype)
    before = qb.quantize_wire.launches
    codes, scales = qb.quantize_wire(x)
    torch.cuda.synchronize()
    assert qb.quantize_wire.launches == before + 1
    pc, ps = qb.quantize_wire_plain(x)
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (qb.wire_padded(n),)
    assert torch.equal(codes, pc) and torch.equal(scales, ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", WIRE_SIZES)
def test_dequantize_wire_kernel_matches_plain(cuda, n, dtype):
    codes, scales = qb.quantize_wire_plain(_wire_values(n, cuda, torch.float32))
    before = qb.dequantize_wire.launches
    out = qb.dequantize_wire(codes, scales, n, dtype)
    torch.cuda.synchronize()
    assert qb.dequantize_wire.launches == before + 1
    want = qb.dequantize_wire_plain(codes, scales, n, dtype)
    assert out.dtype == dtype and torch.equal(out, want)


#: the CUDA one-side kernel's tile (``csrc/fused_elastic.cu``): sizes
#: around one tile, and two full persistent waves of 132 SMs plus a
#: ragged tile
ONE_SIDE_TILE = int(re.search(r"constexpr int TILE = (\d+);", (
    Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
    / "fused_elastic.cu").read_text())[1])
ONE_SIDE_SIZES = (0, 1, 3, 4095, 4096, 4097, 2 * 132 * ONE_SIDE_TILE + 17)
PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


def _one_side_inputs(n, device, w_dtype, c_dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(n, generator=gen, device=device)
    c = w + 0.1 * torch.randn(n, generator=gen, device=device)
    return w.to(w_dtype), c.to(c_dtype)


@pytest.mark.parametrize("side", ["client", "server"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "w%s-c%s" % tuple(
    str(d).split(".")[1] for d in p))
@pytest.mark.parametrize("n", ONE_SIDE_SIZES)
def test_elastic_one_side_kernel_matches_plain(cuda, n, pair, side):
    """Eq. (3) / eq. (2) alone, through the CUDA kernel: the difference
    rounded, then one fused multiply-add in the kernel, the exact product
    and sum rounded once in the plain version — equal for every (w, w̃)
    dtype pair, in the output dtype of w (client) or w̃ (server)."""
    w, c = _one_side_inputs(n, cuda, *pair, 130 + n)
    kernel = getattr(fe, f"elastic_{side}_flat")
    plain = getattr(fe, f"elastic_{side}_flat_plain")
    for a in (0.5, 0.5 / 3):
        alpha = torch.tensor(a, device=cuda)
        before = kernel.launches
        got = kernel(w, c, alpha)
        torch.cuda.synchronize()
        assert kernel.launches == before + (1 if n else 0)
        want = plain(w, c, alpha)
        assert got.dtype == (c if side == "server" else w).dtype
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("side", ["client", "server", "center"])
def test_elastic_one_side_kernel_on_a_side_stream(cuda, side):
    """Launched on the current stream: on a non-default stream, equal to
    the plain version once that stream is synchronised."""
    n = 3 * 132 * ONE_SIDE_TILE + 5
    w, c = _one_side_inputs(n, cuda, torch.float32, torch.float32, 7)
    alpha = torch.tensor(0.5 / 3, device=cuda)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    kernel = getattr(fe, f"elastic_{side}_flat")
    with torch.cuda.stream(stream):
        got = kernel(w, c, alpha)
    stream.synchronize()
    assert torch.equal(got, getattr(fe, f"elastic_{side}_flat_plain")(w, c, alpha))


@pytest.mark.parametrize("side", ["client", "server", "center"])
def test_elastic_one_side_kernel_rejects_misaligned(cuda, side):
    """The bulk copies need 16-byte aligned data: a view one f32 into a
    fresh buffer raises, and launches nothing."""
    buf = torch.zeros(4097, device=cuda)
    alpha = torch.tensor(0.5, device=cuda)
    kernel = getattr(fe, f"elastic_{side}_flat")
    before = kernel.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel(buf[1:], buf[:-1].clone(), alpha)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel(buf[:-1].clone(), buf[1:], alpha)
    with pytest.raises(ValueError, match="dtype"):
        kernel(buf.half(), buf.half(), alpha)
    assert kernel.launches == before


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "c%s-ds%s" % tuple(
    str(d).split(".")[1] for d in p))
@pytest.mark.parametrize("n", ONE_SIDE_SIZES)
def test_elastic_center_kernel_matches_plain(cuda, n, pair):
    """Eq. (2) on a center shard through the CUDA kernel: one fused
    multiply-add in the kernel, the exact product and sum rounded once in
    the plain version — equal for every (w̃, Σ) dtype pair and both α, in
    w̃'s dtype; one launch per call, none for an empty shard."""
    gen = torch.Generator(device=cuda).manual_seed(50 + n)
    c = torch.randn(n, generator=gen, device=cuda).to(pair[0])
    ds = (0.1 * torch.randn(n, generator=gen, device=cuda)).to(pair[1])
    for a in (0.5, 0.5 / 3):
        alpha = torch.tensor(a, device=cuda)
        before = fe.elastic_center_flat.launches
        got = fe.elastic_center_flat(c, ds, alpha)
        torch.cuda.synchronize()
        assert fe.elastic_center_flat.launches == before + (1 if n else 0)
        want = fe.elastic_center_flat_plain(c, ds, alpha)
        assert got.dtype == c.dtype == want.dtype and torch.equal(got, want)


def test_elastic_center_kernel_stacked_rows_match_plain(cuda):
    """The emulated driver's stacked ``(pods, devices, n)`` shards: one
    launch over the whole contiguous buffer, equal to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    c = torch.randn(2, 2, 3 * 4096 + 128, generator=gen, device=cuda).bfloat16()
    ds = 0.1 * torch.randn(2, 2, 3 * 4096 + 128, generator=gen, device=cuda)
    alpha = torch.tensor(0.25, device=cuda)
    before = fe.elastic_center_flat.launches
    got = fe.elastic_center_flat(c, ds, alpha)
    torch.cuda.synchronize()
    assert fe.elastic_center_flat.launches == before + 1
    assert got.shape == c.shape
    assert torch.equal(got, fe.elastic_center_flat_plain(c, ds, alpha))
    with pytest.raises(ValueError, match="contiguous"):
        fe.elastic_center_flat(c.transpose(0, 1), ds, alpha)


@pytest.mark.parametrize("world", ["local", "pod2", "pod4-resized-3"])
def test_sharded_exchange_card_equals_cpu(cuda, world):
    """``elastic_exchange_sharded`` on the card against the CPU on the
    same stacked trees, on every kind of group that calls the center
    kernel: the trivial group (the shard is the whole buffer and Σ is the
    client-diff kernel's own output), a pod group of 2, and a world of 4
    re-split to 3 after a membership change — the shards the collectives
    hand the kernel stay 16-byte aligned, and the result is equal."""
    from repro_torch.core import comm as comm_lib, flatbuf
    from repro_torch.core.elastic import elastic_exchange_sharded
    from repro_torch.tree import tree_leaves, tree_map

    if world == "local":
        comm, lead = comm_lib.LOCAL, ()
    elif world == "pod2":
        comm, lead = comm_lib.Communicator.world(("pod",), (2,)), (2,)
    else:
        comm, lead = comm_lib.Communicator.world(("pod",), (4,)).resized(3), (3,)
    gen = torch.Generator().manual_seed(4)
    member = {"a": torch.randn(5, 700, generator=gen), "b": torch.randn(9, generator=gen)}
    params = tree_map(lambda t: torch.randn(lead + tuple(t.shape), generator=gen)
                      .bfloat16(), member)
    center = tree_map(lambda t: (t.float() + 0.1 * torch.randn(t.shape, generator=gen))
                      .bfloat16(), params)
    spec = flatbuf.spec_for(tree_map(lambda t: t[(0,) * len(lead)], params))
    out = {}
    for dev in ("cpu", "cuda"):
        before = fe.elastic_center_flat.launches
        out[dev] = elastic_exchange_sharded(spec, tree_map(lambda t: t.to(dev), params),
                                            tree_map(lambda t: t.to(dev), center),
                                            0.5 / max(comm.resolve_size(), 1), comm=comm)
        assert fe.elastic_center_flat.launches == before + (dev == "cuda")
    for got, want in zip(tree_leaves(out["cuda"]), tree_leaves(out["cpu"])):
        assert torch.equal(got.cpu(), want)


def test_ps_wrappers_reject_bad_layouts(cuda):
    x = torch.zeros(10, device=cuda)
    alpha = torch.tensor(0.5, device=cuda)
    with pytest.raises(ValueError, match="flat"):
        qb.quantize_wire(torch.zeros(2, 10, device=cuda))
    with pytest.raises(ValueError, match="floating"):
        qb.quantize_wire(torch.zeros(10, dtype=torch.int32, device=cuda))
    codes, scales = qb.quantize_wire(x)
    with pytest.raises(ValueError, match="whole tiles"):
        qb.dequantize_wire(codes, scales, 8193)
    with pytest.raises(ValueError, match="dtype"):
        qb.dequantize_wire(codes.float(), scales, 10)
    with pytest.raises(ValueError, match="several devices"):
        qb.dequantize_wire(codes, scales.cpu(), 10)
    with pytest.raises(ValueError, match="shape"):
        fe.elastic_client_flat(x, torch.zeros(11, device=cuda), alpha)
    with pytest.raises(ValueError, match="alpha"):
        fe.elastic_server_flat(x, x, torch.zeros(2, device=cuda))


def test_reduced_ps_run_card_matches_cpu(cuda):
    """mpi-ESGD over the int8 PS wire through ``algorithms.run`` on the
    reduced model, card against CPU: the simulated clock equal, losses
    and eval metrics within rtol 1e-4, every launch count as the run's
    exchanges and completions give it."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core import algorithms as A
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_grad_fn
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map

    model = build_model(reduced(get_config("qwen2-0.5b")))
    p0 = model.init(device="cpu", seed=0)
    grad = make_grad_fn(model)
    data = dict(vocab_size=256, seq_len=32, batch_size=2, steps_per_epoch=2)
    held = TokenPipeline(DataConfig(**data, shard=99)).batch_at(0, 0)
    cfg = A.AlgoConfig(mode="mpi_esgd", num_workers=4, num_clients=2,
                       num_servers=1, epochs=2, steps_per_epoch=2,
                       esgd_interval=2, compute_time=0.2, jitter=0.1,
                       policy=A.CollectivePolicy(method="multi_ring",
                                                 num_rings=2, wire_dtype="int8"))
    hist = {}
    for dev in ("cpu", "cuda"):
        def evaluate(p, dev=dev):
            with torch.no_grad():
                return float(model.loss_fn(p, {k: v.to(dev) for k, v in held.items()})[0])

        counts = (qb.quantize_wire.launches, fe.elastic_server_flat.launches,
                  fe.elastic_client_flat.launches, fs.sgd_momentum_flat.launches)
        hist[dev] = A.run(
            cfg, lambda gen, dev=dev: tree_map(lambda a: a.to(dev), p0),
            lambda p, b: (lambda out: (out[0], out[2]))(grad(p, b)), evaluate,
            lambda w, dev=dev: TokenPipeline(DataConfig(**data, shard=w), device=dev),
            device=dev)
        if dev == "cuda":
            got = (qb.quantize_wire.launches, fe.elastic_server_flat.launches,
                   fe.elastic_client_flat.launches, fs.sgd_momentum_flat.launches)
            assert [g - c for g, c in zip(got, counts)] == [4, 4, 4, 8]
    c, g = hist["cpu"], hist["cuda"]
    assert (g.times, g.epochs, g.epoch_time) == (c.times, c.epochs, c.epoch_time)
    assert g.pushed_bytes == c.pushed_bytes
    torch.testing.assert_close(torch.tensor(g.losses), torch.tensor(c.losses),
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(torch.tensor(g.metrics), torch.tensor(c.metrics),
                               rtol=1e-4, atol=0)


def test_emulated_int8_reduce_scatter_card_equals_cpu(cuda):
    """One emulated int8 reduce-scatter over a (2, 4) world: the card's
    per-device shards equal the CPU's (the codec is plain PyTorch, and
    its division rounds as IEEE on both)."""
    from repro_torch.core.comm import CollectivePolicy, Communicator
    from repro_torch.core.collectives import WireMeter

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 2 * 8 * 4096, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        meter = WireMeter()
        comm = Communicator.world(("pod", "data"), (2, 4), meter=meter,
                                  policy=CollectivePolicy(method="ring",
                                                          num_rings=2,
                                                          wire_dtype="int8"))
        out[dev] = (comm.reduce_scatter(x.to(dev)), meter.bytes)
    assert out["cuda"][1] == out["cpu"][1]
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0])


# -- the per-hop codec (csrc/wire_hop.cu) ---------------------------------------

HOP_SIZES = (1, 127, 128, 129, 8193, 100_003)


def _hop_rows(n, rows, device, dtype, seed):
    """``rows`` rows of ``_wire_values``-like values (the edge buckets in
    front), each scaled apart so the rows' buckets differ."""
    return torch.stack([_wire_values(n, device, torch.float32) * (seed + r + 1)
                        for r in range(rows)]).to(dtype)


@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", HOP_SIZES)
def test_wire_encode_decode_kernels_match_plain(cuda, n, rows, dtype, strided):
    """``wire_encode`` (rows padded on their own to whole buckets; rows
    evenly strided, as ``select(-2, r)`` leaves them) and ``wire_decode``:
    codes, scales and values equal the plain versions'."""
    x = _hop_rows(n, rows * (2 if strided else 1), cuda, dtype, 0)
    if strided:
        x = x.reshape(rows, 2, n).select(-2, 1)
    before = (qb.wire_encode.launches, qb.wire_decode.launches)
    codes, scales = qb.wire_encode(x)
    out = qb.wire_decode(codes, scales, n)
    torch.cuda.synchronize()
    assert (qb.wire_encode.launches, qb.wire_decode.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    pc, ps = qb.wire_encode_plain(x)
    assert codes.dtype == torch.int8 and codes.shape == pc.shape
    assert torch.equal(codes, pc) and torch.equal(scales, ps)
    want = qb.wire_decode_plain(pc, ps, n)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert torch.equal(out, want)


@pytest.mark.parametrize("last", [False, True], ids=["hop", "last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("n", HOP_SIZES)
def test_wire_decode_add_encode_kernel_matches_plain(cuda, n, rows, dtype, last):
    """The fused hop: received codes and scales plus the local chunk (f32
    or bf16, rows strided) -> the re-encoded sum, or the f32 sum when
    ``last``; equal to the plain composition."""
    codes, scales = qb.wire_encode_plain(_hop_rows(n, rows, cuda, torch.float32, 1))
    local = _hop_rows(n, 2 * rows, cuda, dtype, 5).reshape(rows, 2, n).select(-2, 0)
    before = qb.wire_decode_add_encode.launches
    got = qb.wire_decode_add_encode(codes, scales, local, n, last=last)
    torch.cuda.synchronize()
    assert qb.wire_decode_add_encode.launches == before + 1
    want = qb.wire_decode_add_encode_plain(codes, scales, local, n, last=last)
    got, want = ((got,), (want,)) if last else (got, want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def test_wire_hop_kernels_reject_bad_layouts(cuda):
    x = torch.randn(2, 300, device=cuda)
    codes, scales = qb.wire_encode(x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qb.wire_encode(x.half())
    with pytest.raises(ValueError, match="evenly strided"):
        qb.wire_encode(torch.randn(2, 4, 300, device=cuda)[:, :3])
    with pytest.raises(ValueError, match="want"):
        qb.wire_decode(codes[:, :256], scales, 256)
    with pytest.raises(ValueError, match="outside"):
        qb.wire_decode(codes, scales, 400)
    with pytest.raises(ValueError, match="several devices"):
        qb.wire_decode_add_encode(codes, scales, x.cpu(), 300)
    with pytest.raises(ValueError, match="want"):
        qb.wire_decode_add_encode(codes, scales, x[:, :200], 200)


def test_emulated_int8_rings_card_equal_cpu_through_the_hop_kernels(cuda):
    """The emulated int8 reduce-scatter and allgather over a p = 4 world
    with 2 rings (ragged chunks, strided per-ring shards): the card's
    shards and buffers equal the CPU's, the wire bytes too, and the card
    run went through the hop kernels."""
    from repro_torch.core import collectives as TC

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 2 * 4 * 4096 + 1037, generator=gen)
    out, launches = {}, None
    for dev in ("cpu", "cuda"):
        meter = TC.WireMeter()
        before = (qb.wire_encode.launches, qb.wire_decode.launches,
                  qb.wire_decode_add_encode.launches)
        rs = TC.ring_reduce_scatter(x.to(dev), 0, num_rings=2, wire_dtype="int8",
                                    meter=meter)
        ag = TC.ring_allgather(rs, 0, num_rings=2, wire_dtype="int8", meter=meter)
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(
            (qb.wire_encode.launches, qb.wire_decode.launches,
             qb.wire_decode_add_encode.launches), before))
        out[dev] = (rs.cpu(), ag.cpu(), meter.bytes)
        if dev == "cpu":
            assert launches == (0, 0, 0)
    # RS: one encode and 3 fused hops a ring; AG: one encode and 1 + 3
    # decodes a ring
    assert launches == (2 + 2, 2 * 4, 2 * 3)
    assert out["cuda"][2] == out["cpu"][2]
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def test_wrappers_reject_bad_layouts(cuda):
    p = torch.zeros(10, device=cuda)
    hp = torch.zeros(2, device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        fs.sgd_momentum_flat(p, torch.zeros(10), p, hp)
    with pytest.raises(ValueError, match="shape"):
        fs.sgd_momentum_flat(p, torch.zeros(11, device=cuda), p, hp)
    with pytest.raises(ValueError, match="contiguous"):
        fs.sgd_momentum_flat(p, torch.zeros(20, device=cuda)[::2], p, hp)
    with pytest.raises(ValueError, match="rows|shape"):
        fo.adamw_flat(p, torch.zeros(3, 10, device=cuda), p,
                      torch.zeros(7, device=cuda))
    alpha = torch.tensor(0.5, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        fe.elastic_client_diff_flat(p, torch.zeros(11, device=cuda), alpha)
    with pytest.raises(ValueError, match="alpha"):
        fe.elastic_center_flat(p, p, torch.zeros(2, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        fe.elastic_exchange_flat_mc(torch.zeros(2, 10, device=cuda),
                                    torch.zeros(9, device=cuda), alpha)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw", "adagrad"])
def test_reduced_train_step_card_matches_cpu(cuda, optimizer):
    """Three steps of the reduced model on the card (kernels) and on the
    CPU (plain versions) from the same weights: f32, TF32 off."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.hierarchy import SyncConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.sgd import get_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(reduced(get_config("qwen2-0.5b")))
    kw = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=3e-3, eps=1e-5),
          "adagrad": dict(lr=1e-2, eps=1e-4)}[optimizer]
    opt = get_optimizer(optimizer, **kw)
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=64, batch_size=8))
    states, losses = {}, {}
    for dev in ("cpu", "cuda"):
        state = make_train_state(model, opt, SyncConfig(), device="cpu")
        state = tree_map(lambda a: a.to(dev), state)
        step = make_train_step(model, opt, SyncConfig(), device=dev)
        losses[dev] = []
        for i in range(3):
            state, met = step(state, pipe.batch_at(0, i))
            losses[dev].append(float(met["loss"]))
        states[dev] = state
    torch.testing.assert_close(torch.tensor(losses["cuda"]),
                               torch.tensor(losses["cpu"]), rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(states["cuda"]["params"]),
                    tree_leaves(states["cpu"]["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5)


def test_reduced_shard_driver_card_matches_cpu(cuda):
    """Three steps of the (2, 2) shard driver (mpi_esgd, interval 2, int8
    wire) on the card and on the CPU from the same weights. A value next
    to an int8 rounding boundary can take the neighbouring code on one
    device and not the other (the gradients differ in the last bits), so
    params are held to the reference's band for a quantized leg (rtol
    1e-2, atol 2e-3) and the losses to rtol 1e-4."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.comm import CollectivePolicy
    from repro_torch.core.hierarchy import SyncConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import shard_driver as sd
    from repro_torch.models.model import build_model
    from repro_torch.optim.sgd import sgd
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(reduced(get_config("qwen2-0.5b")))
    opt = sgd(0.1, momentum=0.9)
    sync = SyncConfig(mode="mpi_esgd", num_clients=2, esgd_interval=2,
                      policy=CollectivePolicy(method="ring", num_rings=2,
                                              wire_dtype="int8"))
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=64, batch_size=8))
    states, losses = {}, {}
    for dev in ("cpu", "cuda"):
        state = tree_map(lambda a: a.to(dev), sd.make_driver_state(
            model, opt, sync, (2, 2), device="cpu"))
        step = sd.make_emulated_step(model, opt, sync, (2, 2))
        losses[dev] = []
        for i in range(3):
            state, met = step(state, sd.shard_batch(pipe.batch_at(0, i), (2, 2)))
            losses[dev].append(float(met["loss"]))
        states[dev] = state
    torch.testing.assert_close(torch.tensor(losses["cuda"]),
                               torch.tensor(losses["cpu"]), rtol=1e-4, atol=0)
    for key in ("params", "center"):
        for a, b in zip(tree_leaves(states["cuda"][key]),
                        tree_leaves(states["cpu"][key])):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-2, atol=2e-3)


# -- the faults slice's kernels ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", (1, 1000, 4097, 70000))
@pytest.mark.parametrize("G", (2, 3, 8))
def test_group_reduce_kernel_matches_plain(cuda, G, n, dtype):
    """The sum over G in member order, f32-accumulated: equal."""
    gen = torch.Generator(device=cuda).manual_seed(G * n)
    x = (torch.randn(G, n, generator=gen, device=cuda)
         * torch.exp(3 * torch.randn(G, n, generator=gen, device=cuda))).to(dtype)
    before = tr.group_reduce_flat.launches
    got = tr.group_reduce_flat(x)
    torch.cuda.synchronize()
    assert tr.group_reduce_flat.launches == before + 1
    want = tr.group_reduce_flat_plain(x)
    assert got.dtype == dtype and torch.equal(got, want)


QBLOCK_SIZES = (1, 896, 1023, 1024, 1025, 8 * 1024 + 5, 100_003)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", QBLOCK_SIZES)
def test_quantize_flat_kernel_matches_plain(cuda, n, dtype):
    """Unpadded codes and one scale per 1024 values, equal to the plain
    version's (the last block's absmax over its real values)."""
    x = _wire_values(n, cuda, dtype)
    before = qb.quantize_flat.launches
    codes, scales = qb.quantize_flat(x)
    torch.cuda.synchronize()
    assert qb.quantize_flat.launches == before + 1
    pc, ps = qb.quantize_flat_plain(x)
    assert tuple(codes.shape) == (n,) and tuple(scales.shape) == (-(-n // 1024),)
    assert torch.equal(codes, pc) and torch.equal(scales, ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", QBLOCK_SIZES)
def test_dequantize_flat_kernel_matches_plain(cuda, n, dtype):
    codes, scales = qb.quantize_flat_plain(_wire_values(n, cuda, torch.float32))
    before = qb.dequantize_flat.launches
    out = qb.dequantize_flat(codes, scales, n, dtype)
    torch.cuda.synchronize()
    assert qb.dequantize_flat.launches == before + 1
    want = qb.dequantize_flat_plain(codes, scales, n, dtype)
    assert out.dtype == dtype and torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", ELASTIC_SIZES)
def test_elastic_exchange_kernel_matches_plain(cuda, n, dtype):
    """Eqs. (3) and (2) from one difference, each one fused multiply-add
    in the kernel and the exact product and sum rounded once in the plain
    version: both outputs equal."""
    w, c = _elastic_inputs((n,), cuda, dtype, 170 + n)
    for a in (0.5, 0.5 / 3):
        alpha = torch.tensor(a, device=cuda)
        before = fe.elastic_exchange_flat.launches
        gw, gc = fe.elastic_exchange_flat(w, c, alpha)
        torch.cuda.synchronize()
        assert fe.elastic_exchange_flat.launches == before + 1
        pw, pc = fe.elastic_exchange_flat_plain(w, c, alpha)
        assert torch.equal(gw, pw) and torch.equal(gc, pc)


def test_faults_slice_wrappers_reject_bad_layouts(cuda):
    x = torch.zeros(10, device=cuda)
    with pytest.raises(ValueError, match="G"):
        tr.group_reduce_flat(torch.zeros(17, 10, device=cuda))
    with pytest.raises(ValueError, match="floating"):
        tr.group_reduce_flat(torch.zeros(2, 10, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tr.group_reduce_flat(torch.zeros(2, 20, device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="flat"):
        qb.quantize_flat(torch.zeros(2, 10, device=cuda))
    codes, scales = qb.quantize_flat(x)
    with pytest.raises(ValueError, match="cover"):
        qb.dequantize_flat(codes, scales, 11)
    with pytest.raises(ValueError, match="shape"):
        fe.elastic_exchange_flat(x, torch.zeros(11, device=cuda),
                                 torch.tensor(0.5, device=cuda))


def test_reduced_faulted_run_card_matches_cpu(cuda):
    """mpi-ESGD under a kill and a straggler over the per-leaf int8 codec
    (``flat_exchange=False``) through ``algorithms.run`` on the reduced
    model, card against CPU: the simulated clock and the robustness
    counters equal, losses within rtol 1e-4, the QBLOCK kernels launched
    once per leaf per delivered push."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core import algorithms as A
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_grad_fn
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(reduced(get_config("qwen2-0.5b")))
    p0 = model.init(device="cpu", seed=0)
    grad = make_grad_fn(model)
    data = dict(vocab_size=256, seq_len=32, batch_size=2, steps_per_epoch=4)
    cfg = A.AlgoConfig(mode="mpi_esgd", num_workers=4, num_clients=2,
                       num_servers=1, epochs=1, steps_per_epoch=4,
                       esgd_interval=2, compute_time=0.2, jitter=0.1,
                       flat_exchange=False,
                       faults="kill@3:unit=1;straggle@0:unit=0:factor=3:duration=8",
                       policy=A.CollectivePolicy(method="multi_ring",
                                                 num_rings=2, wire_dtype="int8"))
    hist = {}
    for dev in ("cpu", "cuda"):
        before = qb.quantize_flat.launches
        hist[dev] = A.run(
            cfg, lambda gen, dev=dev: tree_map(lambda a: a.to(dev), p0),
            lambda p, b: (lambda out: (out[0], out[2]))(grad(p, b)),
            lambda p: 0.0,
            lambda w, dev=dev: TokenPipeline(DataConfig(**data, shard=w), device=dev),
            device=dev)
        if dev == "cuda":
            leaves = len(tree_leaves(p0))
            pushes = qb.quantize_flat.launches - before
            assert pushes > 0 and pushes % leaves == 0
    c, g = hist["cpu"], hist["cuda"]
    for f in ("times", "epochs", "epoch_time", "late_pushes", "live_clients",
              "membership_epochs", "pushed_bytes"):
        assert getattr(g, f) == getattr(c, f), f
    assert g.live_clients == 1 and g.membership_epochs == 1
    torch.testing.assert_close(torch.tensor(g.losses), torch.tensor(c.losses),
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-4b", "phi3-medium-14b"])
def test_reduced_serve_card_matches_cpu(cuda, name):
    """The reduced serve path on the card against the CPU from the same
    weights (f32, TF32 off): 8 teacher-forced serve steps' logits and the
    cache within rtol 1e-4, the greedy tokens of ``BatchedServer`` equal,
    and none of the 14 kernels launched."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map

    wrappers = (fs.sgd_momentum_flat, fo.adamw_flat, fo.adagrad_flat,
                qb.quantize_wire, qb.dequantize_wire, qb.quantize_flat,
                qb.dequantize_flat, tr.group_reduce_flat, fe.elastic_exchange_flat,
                fe.elastic_client_flat, fe.elastic_server_flat,
                fe.elastic_client_diff_flat, fe.elastic_center_flat,
                fe.elastic_exchange_flat_mc)
    before = [w.launches for w in wrappers]
    model = build_model(reduced(get_config(name)))
    p0 = model.init(device="cpu", seed=0)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    logits, caches, greedy = {}, {}, {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda a: a.to(dev), p0)
        cache = model.init_cache(2, 8, dev)
        steps = []
        for t in range(toks.shape[1]):
            out, cache = model.serve_step(params, cache, toks[:, t:t + 1].to(dev))
            steps.append(out.cpu())
        logits[dev], caches[dev] = torch.cat(steps, 1), tree_map(lambda a: a.cpu(), cache)
        srv = BatchedServer(model, params, batch=2, max_seq=16, device=dev)
        greedy[dev] = srv.generate(toks[:, :4].to(dev), steps=6).cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-5)
    for key in ("k", "v"):
        torch.testing.assert_close(caches["cuda"][key], caches["cpu"][key],
                                   rtol=1e-4, atol=1e-5)
    assert torch.equal(caches["cuda"]["index"], caches["cpu"]["index"])
    assert torch.equal(greedy["cuda"], greedy["cpu"])
    assert [w.launches for w in wrappers] == before


FAMILIES = ["qwen2-moe-a2.7b", "mixtral-8x7b", "mamba2-130m", "zamba2-1.2b",
            "whisper-base", "paligemma-3b"]


def _with_stubs(cfg, batch, seed):
    """The stub frontends' inputs the audio and VLM families take beside
    the tokens: N(0, 1) audio frames / image embeddings from a seeded CPU
    generator (the same on every device)."""
    gen = torch.Generator().manual_seed(seed)
    out = dict(batch)
    B = batch["tokens"].shape[0]
    if cfg.is_enc_dec:
        out["audio_frames"] = torch.randn((B, cfg.enc_seq_len, cfg.d_model), generator=gen)
    if cfg.num_image_tokens:
        out["image_embeds"] = torch.randn((B, cfg.num_image_tokens, cfg.d_model),
                                          generator=gen)
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_reduced_family_train_and_serve_card_matches_cpu(cuda, name):
    """The MoE, SSM, hybrid, audio enc-dec and VLM families reduced, f32,
    TF32 off, from the same weights (the last two with stub frame / image
    embeddings beside the tokens): three momentum-SGD steps on the card (one
    ``sgd_momentum_flat`` launch each) and on the CPU, losses within rtol
    1e-4; twelve serve steps' logits and the cache within rtol 1e-4 /
    atol 1e-5, greedy tokens equal; a card serve step makes no host sync."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.hierarchy import SyncConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.sgd import get_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(reduced(get_config(name)))
    opt = get_optimizer("sgd", lr=0.1, momentum=0.9)
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=80, batch_size=4))
    p0 = model.init(device="cpu", seed=0)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    losses, logits, caches, greedy = {}, {}, {}, {}
    for dev in ("cpu", "cuda"):
        state = make_train_state(model, opt, SyncConfig(), device="cpu")
        state["params"] = p0
        state = tree_map(lambda a: a.to(dev), state)
        step = make_train_step(model, opt, SyncConfig(), device=dev)
        before = fs.sgd_momentum_flat.launches
        losses[dev] = []
        for i in range(3):
            state, met = step(state, _with_stubs(model.cfg, pipe.batch_at(0, i), i))
            losses[dev].append(float(met["loss"]))
        if dev == "cuda":
            assert fs.sgd_momentum_flat.launches == before + 3
        params = tree_map(lambda a: a.to(dev), p0)
        cache = model.init_cache(2, 16, dev)
        steps = []
        for t in range(toks.shape[1]):
            out, cache = model.serve_step(params, cache, toks[:, t:t + 1].to(dev))
            steps.append(out.cpu())
        if dev == "cuda":   # the step's inputs on the card before the check
            fresh, tok = model.init_cache(2, 16, dev), toks[:, :1].to(dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                model.serve_step(params, fresh, tok)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        logits[dev], caches[dev] = torch.cat(steps, 1), tree_map(lambda a: a.cpu(), cache)
        srv = BatchedServer(model, params, batch=2, max_seq=24, device=dev)
        greedy[dev] = srv.generate(toks[:, :6].to(dev), steps=8).cpu()
    torch.testing.assert_close(torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(caches["cuda"]), tree_leaves(caches["cpu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert torch.equal(greedy["cuda"], greedy["cpu"])


@pytest.mark.parametrize("image_size", [8, 7])
def test_resnet_forward_and_grads_card_match_cpu(cuda, image_size):
    """The example's ResNet (8 px: a stride-2 ``"SAME"`` conv pads (0, 1);
    7 px: (1, 1)) from the same seed: logits rtol 1e-4 / atol 1e-5 and
    grads rtol 1e-4 of each leaf's largest, card against CPU (TF32 off)."""
    from repro_torch.configs.resnet50_cifar import ResNetConfig
    from repro_torch.data.pipeline import DataConfig, ImagePipeline
    from repro_torch.launch.hybrid_ps_mpi import make_grad_fn
    from repro_torch.models.resnet import init_resnet, resnet_apply
    from repro_torch.tree import tree_leaves

    cfg = ResNetConfig(stage_sizes=(1, 1), width=8, image_size=image_size)
    out = {}
    for dev in ("cpu", "cuda"):
        p = init_resnet(torch.Generator().manual_seed(0), cfg, dev)
        b = ImagePipeline(DataConfig(batch_size=8), image_size=image_size,
                          device=dev).batch_at(0, 0)
        with torch.no_grad():
            logits = resnet_apply(p, b["images"], cfg).cpu()
        loss, g = make_grad_fn(cfg)(p, b)
        out[dev] = (logits, float(loss), [x.cpu() for x in tree_leaves(g)])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * abs(out["cpu"][1])
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_resnet_mpi_esgd_int8_card_matches_cpu(cuda):
    """The example's ResNet through ``algorithms.run`` (mpi-ESGD over the
    int8 PS wire, 2 epochs of 4 steps): the clock equal, losses rtol 1e-4,
    accuracy within one test sample, and on the card the PS-tier kernels
    launched once per push."""
    from repro_torch.core.comm import CollectivePolicy
    from repro_torch.launch import hybrid_ps_mpi as hyb

    cfg = hyb.example_config("mpi_esgd", epochs=2, steps_per_epoch=4,
                             policy=CollectivePolicy(method="multi_ring", num_rings=2,
                                                     wire_dtype="int8"))
    wrappers = (qb.quantize_wire, qb.dequantize_wire, fe.elastic_client_flat,
                fe.elastic_server_flat)
    hist, launched = {}, {}
    for dev in ("cpu", "cuda"):
        before = [w.launches for w in wrappers]
        hist[dev] = hyb.run_example(cfg, dev)
        launched[dev] = [w.launches - b for w, b in zip(wrappers, before)]
    c, g = hist["cpu"], hist["cuda"]
    for f in ("times", "epochs", "epoch_time", "mean_staleness", "pushed_bytes"):
        assert getattr(g, f) == getattr(c, f), f
    torch.testing.assert_close(torch.tensor(g.losses), torch.tensor(c.losses),
                               rtol=1e-4, atol=0)
    assert max(abs(a - b) for a, b in zip(g.metrics, c.metrics)) <= 1 / 256 + 1e-9
    pushes = launched["cuda"][0]
    assert pushes > 0 and launched["cuda"] == [pushes] * 4 and launched["cpu"] == [0] * 4


# -- slice 11: the socket PS tier on the card ---------------------------------

def test_kvserver_exchange_launches_server_kernel_once(cuda):
    """A ``KVServer(device="cuda")`` elastic exchange: the pushed buffer is
    decoded onto the card, Elastic1 is one ``elastic_server_flat`` launch,
    the new center ``==`` the plain version on the same operands, and the
    reply is the old center's bytes."""
    from repro_torch.core.algorithms import AlgoConfig
    from repro_torch.net import wire
    from repro_torch.net.kvserver import KVServer

    cfg = AlgoConfig(mode="dist_esgd", num_workers=2, num_clients=2, esgd_alpha=0.25)
    srv = KVServer(cfg, device="cuda")
    gen = torch.Generator().manual_seed(11)
    c0, w = torch.randn(4096, generator=gen), torch.randn(4096, generator=gen)
    meta, payload = wire.encode_buffer(c0)
    srv.handle("init", dict(meta, key="c"), payload)
    assert srv.kv.value("c").device.type == "cuda"
    before = [fe.elastic_server_flat.launches, fe.elastic_client_flat.launches]
    meta, payload = wire.encode_buffer(w)
    rm, rp = srv.handle("elastic_exchange", dict(meta, key="c", unit=0), payload)
    torch.cuda.synchronize()
    assert [fe.elastic_server_flat.launches, fe.elastic_client_flat.launches] == \
        [before[0] + 1, before[1]]
    assert rp == wire.encode_buffer(c0)[1]
    want = fe.elastic_server_flat_plain(w.cuda(), c0.cuda(),
                                        torch.tensor(0.25, device="cuda"))
    assert torch.equal(srv.kv.value("c"), want)


def test_net_entry_points_raise_without_a_card():
    """``KVServer``, ``RemoteKVStore``, ``build_problem`` and ``run_worker``
    on ``device="cuda"`` raise on a machine without a card (no CPU
    fallback), before any socket is touched."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.algorithms import AlgoConfig
    from repro_torch.net.kvserver import KVServer
    from repro_torch.net.problem import build_problem
    from repro_torch.net.remote_kv import RemoteKVStore
    from repro_torch.net.worker import run_worker

    calls = [lambda: KVServer(AlgoConfig(mode="dist_sgd")),
             lambda: RemoteKVStore({0: object()}),
             lambda: build_problem("logreg8"),
             lambda: run_worker(rank=0, rendezvous_addr="127.0.0.1:9")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_run_job_loopback_card_matches_cpu(cuda):
    """``run_job`` with loopback worker threads and KV server on the card:
    dist_sgd on logreg8, its per-step losses and metrics within rtol 1e-4
    of the same job on the CPU; one momentum-SGD launch per worker step."""
    import numpy as np

    from repro_torch.core.algorithms import AlgoConfig
    from repro_torch.launch.run_local import run_job

    cfg = AlgoConfig(mode="dist_sgd", num_workers=2, num_clients=2, num_servers=1,
                     lr=0.05, epochs=1, steps_per_epoch=3, seed=0)
    before = fs.sgd_momentum_flat.launches
    card = run_job(cfg, transport="loopback", device="cuda")
    assert fs.sgd_momentum_flat.launches == before + 6
    host = run_job(cfg, transport="loopback", device="cpu")
    assert len(card.losses) == 3 and card.exit_codes == host.exit_codes
    np.testing.assert_allclose(card.losses, host.losses, rtol=1e-4)
    np.testing.assert_allclose(card.metrics, host.metrics, rtol=1e-4)


def test_launch_entry_points_raise_without_a_card():
    """``run_job`` on ``device="cuda"`` raises without a card, before any
    process or thread starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.algorithms import AlgoConfig
    from repro_torch.launch.run_local import run_job

    cfg = AlgoConfig(mode="dist_sgd", num_workers=1, num_clients=1, num_servers=1)
    for transport in ("tcp", "loopback"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_job(cfg, transport=transport)


def test_process_mesh_on_the_card_equals_emulated(cuda):
    """Two gloo ranks on the card, each its own process and CUDA context
    (card tensors staged through pinned host memory), against the
    emulated p = 2 driver on the card from the same weights and batches:
    mpi_sgd over the int8 wire and mpi_esgd at f32, 3 steps each. The
    gathered rank blocks, the metrics and the wire bytes are ``==``."""
    import _torch_mesh as TM
    from repro_torch.launch import shard_driver as SD
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.tree import tree_leaves

    params = TM.model().init(device="cpu", seed=1)
    gen = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(3):
        toks = torch.randint(0, 1024, (4, 32), generator=gen, dtype=torch.int32)
        batches.append({"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    cases = [dict(mode="mpi_sgd", opt="sgd", wire="int8"),
             dict(mode="mpi_esgd", opt="sgd", clients=2)]
    ranks = spawn_ranks(TM.driver_rank, (2,), ("dev",), backend="gloo",
                        device="cuda", args=(cases, params, batches))
    for i, case in enumerate(cases):
        emu = TM.emulated_case(case, 2, params, batches, device="cuda")
        got = SD.gather_blocks([r[i]["state"] for r in ranks])
        for key, tree in emu["state"].items():
            for a, b in zip(tree_leaves(got[key]), tree_leaves(tree)):
                assert torch.equal(a, b.cpu()), (case, key)
        for r in ranks:
            assert r[i]["wire"] == emu["wire"]
            assert [float(m["loss"]) for m in r[i]["metrics"]] == \
                [float(m["loss"]) for m in emu["metrics"]]


def test_gspmd_on_the_card_equals_one_process(cuda):
    """The GSPMD path as two gloo ranks (model 2) on the card — DTensor
    state, its collectives staged through pinned host memory — against
    the one-process per-leaf step on the card: 3 momentum-SGD steps of
    the reduced model, losses and every leaf of the gathered state
    within rtol 1e-5 (of the value and of the leaf's scale)."""
    import _torch_gspmd as G
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.tree import tree_leaves

    case = dict(opt="sgd")
    ranks = spawn_ranks(G.case_rank, (2,), ("model",), backend="gloo",
                        device="cuda", args=(case, "cuda"))
    want = G.run_case(None, case, device="cuda")
    for r in ranks:
        torch.testing.assert_close(torch.tensor(r["losses"]),
                                   torch.tensor(want["losses"]), rtol=1e-5, atol=0)
        for key in want["state"]:
            for a, b in zip(tree_leaves(r["state"][key]), tree_leaves(want["state"][key])):
                scale = float(b.float().abs().max()) if b.numel() else 0.0
                torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                           atol=1e-5 * scale)


def test_moe_on_the_card_mesh_equals_one_process(cuda):
    """The reduced qwen2-moe on 4 gloo ranks of the card laid out ('data',
    'expert', 'tp') = (2, 2, 1) — each rank routing its own rows, the
    expert buffers on 'expert', every DTensor collective staged — against
    the one-process run on the card: one momentum-SGD step (loss and the
    gathered state within rtol 1e-5 of the value and of each leaf's
    scale) and one decode token (logits and cache within the same)."""
    import _torch_gspmd_families as G
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.tree import tree_leaves

    ranks = spawn_ranks(G.card_case, (2, 2, 1), G.MOE_AXES, backend="gloo",
                        device="cuda", args=("cuda",))
    want = G.card_case(None, "cuda")

    def close(a, b):
        scale = float(b.float().abs().max()) if b.numel() else 0.0
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5, atol=1e-5 * scale)

    for r in ranks:
        torch.testing.assert_close(torch.tensor(r["train"]["losses"]),
                                   torch.tensor(want["train"]["losses"]), rtol=1e-5, atol=0)
        for a, b in zip(tree_leaves(r["train"]["state"]), tree_leaves(want["train"]["state"])):
            close(a, b)
        close(r["decode"]["logits"], want["decode"]["logits"])
        for a, b in zip(tree_leaves(r["decode"]["cache"]), tree_leaves(want["decode"]["cache"])):
            close(a, b)


def test_encdec_on_the_card_mesh_equals_one_process(cuda):
    """The reduced whisper-base on 4 gloo ranks of the card laid out
    (data 2, model 2) — the encoder stack, cross-attention over the
    encoder output, the decode step's ``enc`` cache leaf (batch on 'data',
    d on 'model', set to a nonzero encoder output), every DTensor
    collective staged — against the one-process run on the card: one
    momentum-SGD step (loss and the gathered state within rtol 1e-5 of
    the value and of each leaf's scale) and one decode token (logits and
    cache within the same)."""
    import _torch_gspmd_families as G
    from repro_torch.launch.mesh import spawn_ranks

    ranks = spawn_ranks(G.card_case, (2, 2), G.DENSE_AXES, backend="gloo",
                        device="cuda", args=("cuda", "whisper-base"))
    want = G.card_case(None, "cuda", "whisper-base")
    for r in ranks:
        torch.testing.assert_close(torch.tensor(r["train"]["losses"]),
                                   torch.tensor(want["train"]["losses"]), rtol=1e-5, atol=0)
        G.close_trees(r["train"]["state"], want["train"]["state"])
        G.close(r["decode"]["logits"], want["decode"]["logits"])
        G.close_trees(r["decode"]["cache"], want["decode"]["cache"])
