"""The port's policy autotuner and roofline analysis
(``repro_torch.launch.{autotune,analysis}``) against the reference's on
the same inputs: the grid, the pruned candidates and their reasons, the
scores and ranking of ``autotune`` / ``autotune_for_model`` and the
table, at equal ``NetParams`` (the reference's TPU preset's values and
the paper's testbed) with the reference's compute rates passed to the
port; ``parse_collectives``, ``Roofline``, ``overlap_projection`` and the
flops helpers on the reference's HLO snippet and inputs; the train
CLI's ``--policy auto`` lowered to the reference's chosen policy when the
port's rates are set to the reference's. The reference's two tests that
read ``BENCH_*.json`` are held through the reference at equal
``NetParams``: the port is not judged against TPU measurements."""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro.core import comm as jcomm, cost_model as jcost  # noqa: E402
from repro.launch import analysis as janalysis, autotune as jtune  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import comm as tcomm, cost_model as tcost  # noqa: E402
from repro_torch.launch import analysis as tanalysis, autotune as ttune  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

#: the reference's bench geometry: 8 devices, the reduced qwen2-0.5b
#: packed f32 gradient payload
P = 8
NBYTES = 1572864
#: the reference's compute rates, passed to the port by keyword
REF_RATES = dict(peak_flops=janalysis.PEAK_FLOPS)
NETS = {
    "tpu-preset-values": (jcost.tpu_v5e(),
                          tcost.NetParams(**dataclasses.asdict(jcost.tpu_v5e()))),
    "testbed": (jcost.testbed(), tcost.testbed()),
}
GEOMETRIES = {
    "bench": dict(nbytes=NBYTES, p=P, compute_s=0.0),
    "bench-fused": dict(nbytes=NBYTES, p=P,
                        compute_s=jtune.fused_step_compute_s(NBYTES)),
    "1GiB-overlap": dict(nbytes=float(1 << 30), p=P, compute_s=1.0),
    "p1": dict(nbytes=NBYTES, p=1, compute_s=1e-3),
    "p2": dict(nbytes=3.0e6, p=2, compute_s=2e-4),
    "p5": dict(nbytes=7.7e7, p=5, compute_s=5e-3),
}


def _tpol(jpol):
    return tcomm.CollectivePolicy.from_dict(jpol.to_dict())


def _same_result(got, want):
    assert got.to_dict() == want.to_dict()
    assert ttune.format_table(got) == jtune.format_table(want)
    assert ttune.format_table(got, top=len(got.ranked)) == \
        jtune.format_table(want, top=len(want.ranked))


def test_grid_equal():
    assert [p.to_dict() for p in ttune.enumerate_policies()] == \
        [p.to_dict() for p in jtune.enumerate_policies()]


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_autotune_equal(geom, net):
    """Scores, ranking, pruned reasons and table equal at equal rates."""
    jnet, tnet = NETS[net]
    g = GEOMETRIES[geom]
    _same_result(ttune.autotune(**g, net=tnet), jtune.autotune(**g, net=jnet))


@pytest.mark.parametrize("geom", ["bench", "p2", "p5"])
def test_score_and_bytes_per_policy_equal(geom):
    g = GEOMETRIES[geom]
    jnet, tnet = NETS["testbed"]
    for jp in jtune.enumerate_policies():
        tp = _tpol(jp)
        assert ttune.policy_bytes_per_step(tp, g["nbytes"], g["p"]) == \
            jtune.policy_bytes_per_step(jp, g["nbytes"], g["p"])
        try:
            jp.validate()
        except ValueError:
            continue
        got = ttune.score_policy(tp, **g, net=tnet, num_leaves=17)
        want = jtune.score_policy(jp, **g, net=jnet, num_leaves=17)
        assert got.to_dict() == want.to_dict()


def test_default_net_is_the_papers_testbed():
    """The port's default network is ``testbed()``: with no ``net`` it
    scores as the reference does given the testbed explicitly."""
    g = GEOMETRIES["bench-fused"]
    _same_result(ttune.autotune(**g), jtune.autotune(**g, net=jcost.testbed()))


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("arch,full", [("qwen3-4b", True), ("qwen2-0.5b", True),
                                       ("qwen2-0.5b", False),
                                       ("qwen2-moe-a2.7b", True)])
def test_autotune_for_model_equal(arch, full, net):
    jnet, tnet = NETS[net]
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    if not full:
        jcfg, tcfg = jbase.reduced(jcfg), tbase.reduced(tcfg)
    for p, tokens in ((P, 1 << 20), (4, 4096 * 256), (1, 8 * 64)):
        _same_result(
            ttune.autotune_for_model(tcfg, p=p, tokens_per_step=tokens,
                                     net=tnet, **REF_RATES),
            jtune.autotune_for_model(jcfg, p=p, tokens_per_step=tokens, net=jnet))
        assert ttune.compute_s_for_model(tcfg, tokens, p, **REF_RATES) == \
            jtune.compute_s_for_model(jcfg, tokens, p)


def test_fused_step_compute_s_takes_the_rate():
    assert ttune.fused_step_compute_s(NBYTES, hbm_bw=janalysis.HBM_BW) == \
        jtune.fused_step_compute_s(NBYTES)
    assert ttune.fused_step_compute_s(NBYTES) == 5.0 * NBYTES / 3.35e12


def test_bench_geometry_choice_equals_the_references():
    """The reference's two BENCH-reading tests, held through the
    reference: at the bench geometry the port's per-wire ring bytes and
    its chosen policy (with the fused-step compute) equal the
    reference's, and the winner is an int8 ring-family policy."""
    for wire in (None, "bf16", "int8"):
        jp = jcomm.CollectivePolicy(method="ring", wire_dtype=wire)
        assert ttune.policy_bytes_per_step(_tpol(jp), NBYTES, P) == \
            jtune.policy_bytes_per_step(jp, NBYTES, P)
    jnet, tnet = NETS["tpu-preset-values"]
    compute = ttune.fused_step_compute_s(NBYTES, hbm_bw=janalysis.HBM_BW)
    got = ttune.autotune(nbytes=NBYTES, p=P, compute_s=compute, net=tnet)
    want = jtune.autotune(nbytes=NBYTES, p=P,
                          compute_s=jtune.fused_step_compute_s(NBYTES))
    assert got.chosen.to_dict() == want.chosen.to_dict()
    assert got.chosen.policy.method in ("ring", "multi_ring", "scatter_gather")
    assert got.chosen.policy.wire == "int8"


def test_ranking_orders_wire_dtypes():
    result = ttune.autotune(nbytes=NBYTES, p=P)
    ring = [s for s in result.ranked
            if s.policy.method == "ring" and not s.policy.overlap
            and s.policy.bucket_bytes is None]
    assert [s.policy.wire for s in ring] == ["int8", "bf16", None]


def test_overlap_wins_when_compute_hides_the_wire():
    result = ttune.autotune(nbytes=float(1 << 30), p=P, compute_s=1.0)
    pol = result.chosen.policy
    assert pol.overlap and pol.wire == "int8" and pol.num_rings == 1
    assert result.chosen.overlap_fraction > 0.5


def test_every_guard_prunes_at_least_one_candidate():
    reasons = [pr.reason for pr in ttune.autotune(nbytes=NBYTES, p=P).pruned]
    for needle in ("rides the explicit ring hops", "overlap schedules per-bucket",
                   "num_rings must be 1", "bucket_bytes does not compose with overlap"):
        assert any(needle in r for r in reasons), needle


def test_grid_partitions_into_ranked_plus_pruned():
    result = ttune.autotune(nbytes=NBYTES, p=P)
    assert len(result.ranked) + len(result.pruned) == len(ttune.enumerate_policies())
    assert result.ranked and result.pruned
    assert not {pr.policy for pr in result.pruned} & {s.policy for s in result.ranked}
    for s in result.ranked:
        s.policy.validate()


def test_format_table_lists_the_chosen_policy_first():
    result = ttune.autotune(nbytes=NBYTES, p=P,
                            compute_s=ttune.fused_step_compute_s(NBYTES))
    lines = ttune.format_table(result, top=5).splitlines()
    assert lines[0].startswith("| # | method") and len(lines) == 7
    assert f"| {result.chosen.policy.method} |" in lines[2]
    assert (result.chosen.policy.wire_dtype or "f32") in lines[2]


@pytest.mark.parametrize("kw", [dict(nbytes=NBYTES, p=0), dict(nbytes=0, p=P),
                                dict(nbytes=-1.0, p=P)])
def test_degenerate_geometry_refusals_equal(kw):
    with pytest.raises(ValueError) as want:
        jtune.autotune(**kw)
    with pytest.raises(ValueError) as got:
        ttune.autotune(**kw)
    assert str(got.value) == str(want.value)


def test_policy_wire_property_equal():
    for jp in jtune.enumerate_policies():
        assert _tpol(jp).wire == jp.wire
    assert tcomm.CollectivePolicy(wire_dtype="f32").wire is None


# --- analysis -----------------------------------------------------------------

HLO_SNIPPET = """
ENTRY %main {
  %ar = f32[1024,16]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[2048]{0} all-gather(%y), replica_groups=[2,8]<=[16], dimensions={0}
  %cp = f32[64]{0} collective-permute(%z), source_target_pairs={{0,1},{1,0}}
  %rs = f32[128]{0} reduce-scatter(%w), replica_groups={{0,1}}, to_apply=%add
  %a2 = (s8[256,4]{1,0}, f32[8]{0}) all-to-all-start(%u), replica_groups={{0,1,2,3,4,5,6,7}}
  %n = u8[4]{0} all-reduce(%v), to_apply=%add
  %x = f32[9]{0} add(%p, %q)
}
"""


def _stats(s):
    return (s.counts, s.operand_bytes, s.wire_bytes, s.total_ops())


def test_parse_collectives_equal():
    got = tanalysis.parse_collectives(HLO_SNIPPET)
    assert _stats(got) == _stats(janalysis.parse_collectives(HLO_SNIPPET))
    assert got.counts == {"all-reduce": 2, "all-gather": 1, "collective-permute": 1,
                          "reduce-scatter": 1, "all-to-all": 1}
    ar = 1024 * 16 * 4
    want = (2 * 3 / 4 * ar + 7 / 8 * 2048 * 2 + 64 * 4 + 128 * 4
            + 7 / 8 * 256 * 4 + 2 * 4)
    assert got.wire_bytes == pytest.approx(want)
    assert _stats(tanalysis.parse_collectives("")) == \
        _stats(janalysis.parse_collectives(""))


def test_roofline_dominant_term():
    kw = dict(chips=4, hlo_flops=4e12, hlo_bytes=4e9, wire_bytes=4e9,
              compute_s=1e-3, memory_s=5e-3, collective_s=2e-3, model_flops=2e12)
    got, want = tanalysis.Roofline(**kw), janalysis.Roofline(**kw)
    assert got.dominant == "memory" and got.useful_flops_ratio == pytest.approx(0.5)
    assert got.to_dict() == want.to_dict() and got.bound_s == want.bound_s
    assert tanalysis.Roofline(**dict(kw, hlo_flops=0)).useful_flops_ratio == 0.0


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_roofline_from_analysis_equal_at_the_references_rates(wire):
    cost = {"flops": 3.3e12, "bytes accessed": 7.1e9}
    coll = tanalysis.parse_collectives(HLO_SNIPPET)
    got = tanalysis.roofline_from_analysis(
        cost, coll, 16, model_flops=2e13, wire_dtype=wire,
        link_bw=janalysis.ICI_BW, peak_flops=janalysis.PEAK_FLOPS,
        hbm_bw=janalysis.HBM_BW)
    want = janalysis.roofline_from_analysis(
        cost, janalysis.parse_collectives(HLO_SNIPPET), 16, model_flops=2e13,
        wire_dtype=wire)
    assert got.to_dict() == want.to_dict()
    h100 = tanalysis.roofline_from_analysis(cost, coll, 16, link_bw=1e11)
    assert h100.compute_s == 3.3e12 / 989e12 and h100.memory_s == 7.1e9 / 3.35e12
    with pytest.raises(TypeError):
        tanalysis.roofline_from_analysis(cost, coll, 16)   # no link default


@pytest.mark.parametrize("kw", [dict(), dict(bucket_bytes=[1e6, 3e6, 2e6]),
                                dict(num_buckets=1), dict(wire_dtype="int8")])
def test_overlap_projection_equal(kw):
    jnet, tnet = NETS["tpu-preset-values"]
    args = (6e6, 8, 2e-3)
    assert tanalysis.overlap_projection(*args, net=tnet, **kw) == \
        janalysis.overlap_projection(*args, **kw)
    assert tanalysis.overlap_projection(*args, **kw) == \
        janalysis.overlap_projection(*args, net=jcost.testbed(), **kw)


def test_flops_helpers_equal():
    assert tanalysis.train_model_flops(10, 10, 100) == 6 * 10 * 100
    assert tanalysis.decode_model_flops(10, 8) == 2 * 10 * 8
    for args in ((10, 7, 1000), (494_032_768, 494_032_768, 1 << 20)):
        assert tanalysis.train_model_flops(*args) == janalysis.train_model_flops(*args)
    assert tanalysis.decode_model_flops(123, 8) == janalysis.decode_model_flops(123, 8)
    for full in (True, False):
        jcfg, tcfg = jbase.get_config("whisper-base"), tbase.get_config("whisper-base")
        if not full:
            jcfg, tcfg = jbase.reduced(jcfg), tbase.reduced(tcfg)
        for train in (True, False):
            assert tanalysis.enc_dec_model_flops(tcfg, 8, 448, train) == \
                janalysis.enc_dec_model_flops(jcfg, 8, 448, train)


def test_memory_summary_equal():
    class Mem:
        argument_size_in_bytes = 10
        output_size_in_bytes = 20.0
        temp_size_in_bytes = 30
        generated_code_size_in_bytes = None

    assert tanalysis.memory_summary(Mem()) == janalysis.memory_summary(Mem()) == \
        {"argument_size_in_bytes": 10, "output_size_in_bytes": 20,
         "temp_size_in_bytes": 30}


# --- the train CLI's --policy auto ----------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--full-size"], ["--tune-p", "4"],
                                  ["--arch", "qwen3-4b", "--full-size", "--shape", "prefill_32k"],
                                  ["--shape", "no-such-shape"]])
def test_cli_policy_auto_lowers_to_the_references_choice(argv, monkeypatch, capsys):
    """With the port's rates set to the reference's (its default network
    and peak), ``--policy auto`` lowers to the policy the reference's CLI
    chooses for the same flags, and prints its header and table."""
    ref_net = NETS["tpu-preset-values"][1]
    monkeypatch.setattr(tcost, "testbed", lambda: ref_net)
    monkeypatch.setitem(ttune.autotune_for_model.__kwdefaults__, "peak_flops",
                        janalysis.PEAK_FLOPS)
    args = ttrain.build_parser().parse_args(["--policy", "auto", "--device", "cpu"] + argv)
    _, settings = ttrain.settings_from_args(args)
    jcfg = jbase.get_config(args.arch)
    if not args.full_size:
        jcfg = jbase.reduced(jcfg)
    shape = jbase.INPUT_SHAPES.get(args.shape)
    tokens = shape.seq_len * shape.global_batch if shape is not None else 1 << 20
    want = jtune.autotune_for_model(jcfg, p=args.tune_p, tokens_per_step=tokens)
    assert settings.policy.to_dict() == want.chosen.policy.to_dict()
    assert settings.sync_config().policy == settings.policy
    out = capsys.readouterr().out
    assert (f"[train] --policy auto: ranked {len(want.ranked)} valid / "
            f"{len(want.pruned)} pruned candidates at p={args.tune_p}, "
            f"payload={want.nbytes:.0f} B") in out
    assert jtune.format_table(want) in out
