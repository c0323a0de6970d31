"""The plain reference against the port at a small size in float32 on the
CPU: the plan (Eq. 4 and Eq. 5), the tower's tokens, and whole images of
the stale-K/V schedule, unguided, guided and prompt-conditioned."""
import itertools

import pytest
import torch

from conftest import PROMPT, tiny_context
from portbench import weights
from portbench.reference import schedule, tower


def fp32_context(cell, **over):
    return tiny_context(cell, model={"dtype": "float32",
                                     "param_dtype": "float32"}, **over)


@pytest.mark.parametrize("occ", [list(o) for o in itertools.product(
    (0.0, 0.3, 0.5, 0.8), repeat=3)] + [[0.0, 0.5], [0.0] * 4, [0.2, 0.9]])
def test_plan_is_the_ports(occ):
    from repro_torch.core import hetero, schedule as port

    speeds = hetero.speeds(hetero.make_cluster(occ))
    plan = port.temporal_allocation(speeds, 16, 4)
    rows = port.spatial_allocation(speeds, plan.steps, 64)
    assert schedule.plan(occ, 16, 4, 64) == (plan.steps, plan.ratios, rows)


def test_ddim_grid_is_the_ports():
    from repro_torch.core import sampler

    for T, M in ((1000, 16), (1000, 7), (999, 50), (1000, 250)):
        assert schedule.ddim_timesteps(T, M) == sampler.ddim_timesteps(T, M).tolist()


def test_tower_tokens_are_the_ports():
    from repro_torch.models import text_encoder

    ctx = fp32_context(PROMPT)
    for prompt in ("fox", "a red fox in the deep snow",
                   " ".join(["word"] * 13), " ".join(["w%d" % i for i in range(40)])):
        got = text_encoder.encode([prompt], ctx.model_cfg, device="cpu")
        want = tower.encode([prompt], 32, 32, torch.device("cpu"))
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def port_image(ctx, x_T, cond, scale=None):
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline

    plan = ctx.spec["plan"]
    config = StadiConfig.from_occupancies(
        plan["occupancies"], m_base=16, m_warmup=4, planner="stadi",
        backend="emulated", exchange="sync", cfg_scale=scale or 0.0)
    params = weights.make(ctx.model, ctx.seed, "cpu")
    pipe = StadiPipeline(ctx.model_cfg, params, sampler.linear_schedule(1000),
                         config, device="cpu")
    return pipe.generate(x_T, cond).image, params


@pytest.mark.parametrize("scale", [None, 4.0])
def test_class_images_are_the_ports(scale):
    ctx = fp32_context("sdxl-dit.generate")
    x_T = weights.latents(ctx.model, ctx.seed, 1, "cpu")
    cond = torch.tensor([3])
    img, params = port_image(ctx, x_T, cond, scale)
    want, _ = schedule.sample(params, ctx.model, x_T, cond, occupancies=[0.0, 0.5],
                              m_base=16, m_warmup=4, T=1000, beta_min=1e-4,
                              beta_max=2e-2, cfg_scale=scale)
    assert float((img - want).norm() / want.norm()) < 1e-5


def test_prompt_image_is_the_ports():
    from repro_torch.models import text_encoder

    ctx = fp32_context(PROMPT)
    x_T = weights.latents(ctx.model, ctx.seed, 1, "cpu")
    prompt = "a quiet mountain village at dawn"
    tokens = text_encoder.encode([prompt], ctx.model_cfg, device="cpu")
    img, params = port_image(ctx, x_T, tokens, 5.0)
    cond = tower.encode([prompt], 32, 32, torch.device("cpu"))
    want, _ = schedule.sample(params, ctx.model, x_T, cond,
                              occupancies=[0.0, 0.5], m_base=16, m_warmup=4,
                              T=1000, beta_min=1e-4, beta_max=2e-2,
                              cfg_scale=5.0)
    assert float((img - want).norm() / want.norm()) < 1e-5


def test_weights_follow_the_seed():
    ctx = fp32_context(PROMPT)
    a = weights.make(ctx.model, 2**31 + 7, "cpu")
    b = weights.make(ctx.model, 2**31 + 7, "cpu")
    c = weights.make(ctx.model, 2**31 + 8, "cpu")
    assert torch.equal(a["blocks"]["qkv"], b["blocks"]["qkv"])
    assert not torch.equal(a["blocks"]["qkv"], c["blocks"]["qkv"])
