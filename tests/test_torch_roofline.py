"""The port's analytic cost model and roofline (``repro_torch.launch.
analytic``, ``repro_torch.launch.roofline``) against the reference's: the
analytic numbers equal the reference's exactly for every language model x
shape x flash x chip count; the roofline keeps its terms with the H100
constants; the reference's sanity tests hold on the port."""
import pytest

pytest.importorskip("jax")

from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.configs import LANGUAGE, get_config  # noqa: E402
from repro_torch.launch import analytic, mesh, roofline as rl  # noqa: E402
from repro_torch.launch.shapes import SHAPES, ShapeSpec  # noqa: E402


@pytest.mark.parametrize("arch", LANGUAGE)
def test_analytic_equals_reference(arch):
    for shape in SHAPES:
        for flash in (False, True):
            f, jf = (analytic.forward_cost(arch, shape, flash),
                     janalytic.forward_cost(arch, shape, flash))
            assert (f.flops, f.bytes) == (jf.flops, jf.bytes), (shape, flash)
            s, js = (analytic.step_cost(arch, shape, flash),
                     janalytic.step_cost(arch, shape, flash))
            assert (s.flops, s.bytes) == (js.flops, js.bytes), (shape, flash)
            for chips in (256, 512):
                d = analytic.per_device(arch, shape, chips, flash)
                jd = janalytic.per_device(arch, shape, chips, flash)
                assert (d.flops, d.bytes) == (jd.flops, jd.bytes)
        assert rl.model_flops_for(arch, shape) == jrl.model_flops_for(arch, shape)


def test_shape_spec_prices_like_its_name():
    spec = SHAPES["prefill_32k"]
    same = ShapeSpec(spec.name, spec.kind, spec.seq, spec.batch)
    for arch in LANGUAGE:
        a, b = analytic.step_cost(arch, same, True), analytic.step_cost(arch, "prefill_32k", True)
        assert (a.flops, a.bytes) == (b.flops, b.bytes)
    # a cut shape: gemma-2b prefill of one 2048-token prompt
    small = ShapeSpec("gemma_prompt", "prefill", 2048, 1)
    c = analytic.forward_cost("gemma-2b", small, flash=True)
    assert 0 < c.flops < analytic.forward_cost("gemma-2b", "prefill_32k", True).flops


@pytest.mark.parametrize("flash", [False, True])
def test_build_terms_use_h100_constants(flash):
    coll = {"total": 123_456_789}
    for arch in ("gemma-2b", "olmoe-1b-7b", "xlstm-125m"):
        for shape in SHAPES:
            r = rl.build(arch, shape, "pod16x16", 256, {"flops": 7.0}, coll, flash)
            jr = jrl.build(arch, shape, "pod16x16", 256, {"flops": 7.0}, coll, flash)
            assert r.flops_per_device == jr.flops_per_device
            assert r.bytes_per_device == jr.bytes_per_device
            assert r.compute_s * 989e12 == pytest.approx(jr.compute_s * 197e12,
                                                          rel=1e-15)
            assert r.memory_s * 3.35e12 == pytest.approx(jr.memory_s * 819e9,
                                                          rel=1e-15)
            assert r.collective_s == coll["total"] / 50e9
            assert r.raw_hlo_flops == 7.0
            assert set(r.to_dict()) == set(jr.to_dict())
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.LINK_BW) == (989e12, 3.35e12, 50e9)


def test_collective_bytes_from_records():
    recs = [{"kind": "all-reduce", "bytes": 512 * 12, "mesh_dim": "model",
             "count": 12},
            {"kind": "all-gather", "bytes": 512 * 12, "mesh_dim": "data",
             "count": 12},
            {"kind": "all-gather", "bytes": 512, "mesh_dim": "model"}]
    out = rl.collective_bytes(recs)
    assert out["all-reduce"] == 512 * 12
    assert out["all-gather"] == 512 * 12 + 512
    assert out["total"] == 512 * 12 * 2 + 512
    assert out["_counts"]["all-gather"] == 13
    assert set(out) == set(jrl.collective_bytes(""))


def test_analytic_ratios_sane():
    for arch in ("gemma-2b", "yi-9b", "minitron-8b", "llama3-405b"):
        c = analytic.step_cost(arch, "train_4k")
        nd = rl.model_flops_for(arch, "train_4k")
        assert 0.7 < nd / c.flops < 1.3, (arch, nd / c.flops)


def test_analytic_flash_reduces_bytes():
    naive = analytic.step_cost("yi-9b", "prefill_32k", flash=False)
    flash = analytic.step_cost("yi-9b", "prefill_32k", flash=True)
    assert flash.bytes < 0.5 * naive.bytes
    assert flash.flops == naive.flops


def test_analytic_decode_memory_bound():
    """Decode is memory-bound on an H100 as on the TPU."""
    c = analytic.per_device("llama3-405b", "decode_32k", 256)
    assert c.bytes / mesh.HBM_BW > c.flops / mesh.PEAK_FLOPS_BF16
    r = rl.build("llama3-405b", "decode_32k", "pod16x16", 256, {}, {})
    assert r.dominant == "memory"


@pytest.mark.parametrize("arch", LANGUAGE)
def test_streamed_weight_bytes_is_the_double_count(arch):
    """The separate streamed-weight term of step_cost's bytes: the active
    weights in bf16 at decode, all of them otherwise, three forwards' worth
    in training; a part of the step's bytes at every shape."""
    cfg = get_config(arch)
    for name in SHAPES:
        kind = SHAPES[name].kind
        w = (2.0 * cfg.active_param_count() if kind == "decode"
             else 2.0 * cfg.param_count())
        want = 3.0 * w if kind == "train" else w
        got = analytic.streamed_weight_bytes(arch, name)
        assert got == want
        assert 0 < got < analytic.step_cost(arch, name).bytes


def test_model_flops_moe_uses_active():
    cfg = get_config("olmoe-1b-7b")
    assert cfg.active_param_count() < 0.35 * cfg.param_count()
    assert rl.model_flops_for("olmoe-1b-7b", "train_4k") == \
        6.0 * cfg.active_param_count() * 256 * 4096


def test_flops_per_device_matches_reference_dryrun_file():
    """The analytic terms of the reference's dry-run report for xlstm-125m
    decode_32k on 16x16, from the reference's ``roofline.build`` (what its
    ``launch/dryrun.py`` writes into ``results/dryrun/``, which is not kept
    in git)."""
    ref = jrl.build("xlstm-125m", "decode_32k", "pod16x16", 256, {}, {}).to_dict()
    r = rl.build("xlstm-125m", "decode_32k", "pod16x16", 256, {}, {})
    assert r.flops_per_device == ref["flops_per_device"]
    assert r.bytes_per_device == ref["bytes_per_device"]
    assert r.model_flops == ref["model_flops"]
