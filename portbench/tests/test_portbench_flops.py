"""The yardstick's operation counts against the figures they were
predicted from: 77.8 TFLOP an image of the generate cell (4 full-image
forwards, 12 patches of 2304 tokens, 6 of 1792) and 93.1 TFLOP of useful
work an image of the spmd cell (4 full-image forwards, 48 patches of
1024 tokens)."""
import json
import os

import pytest

from conftest import ROOT
from portbench import flops
from portbench.reference import schedule


@pytest.fixture(scope="module")
def model():
    with open(os.path.join(ROOT, "portbench", "configs", "sdxl-dit.json")) as f:
        return json.load(f)["model"]


def image_ops(model, occupancies):
    """Operations of one image's forwards under the stadi plan."""
    side = model["latent_size"] // model["patch_size"]
    steps, ratios, rows = schedule.plan(occupancies, 16, 4, side)
    n = side * side
    lcm = max(ratios)
    ops = 4 * flops.dit_forward(model, 1, n, n)
    for r, k in zip(ratios, rows):
        if r:
            ops += (12 // lcm) * (lcm // r) * flops.dit_forward(model, 1, k * side, n)
    return ops, steps, rows


def test_generate_cell_image(model):
    ops, steps, rows = image_ops(model, [0.0, 0.5])
    assert (steps, rows) == ([16, 10], [36, 28])
    assert ops == pytest.approx(77.8e12, rel=5e-3)


def test_spmd_cell_image(model):
    ops, steps, rows = image_ops(model, [0.0, 0.0, 0.0, 0.0])
    assert (steps, rows) == ([16] * 4, [16] * 4)
    assert ops == pytest.approx(93.1e12, rel=5e-3)


def test_per_token_cost_and_prompt_read(model):
    per_token = flops.dit_forward(model, 1, 4096, 4096) / 4096
    assert per_token == pytest.approx(1.42e9, rel=5e-3)
    text = dict(model, cross_attn=True)
    extra = flops.dit_forward(text, 1, 4096, 4096, 32) \
        - flops.dit_forward(text, 1, 4096, 4096)
    D, L = model["d_model"], model["n_layers"]
    assert extra == L * (4096 * (4 * D * D + 4 * 32 * D)
                         + 2 * model["cond_dim"] * 2 * D * 32) \
        + 2 * model["cond_dim"] * D


def test_attention_kernel_counts():
    ops, nbytes = flops.attention_kernel(1, 16, 2304, 4096, 72)
    assert ops == 4 * 16 * 2304 * 4096 * 72
    # q, fresh k and v, out: 2304 rows each; stale k and v: 1792 rows each
    assert nbytes == 2 * 16 * 72 * (4 * 2304 + 2 * 1792)
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    assert flops.least_seconds(ops, nbytes, peak) == pytest.approx(ops / 989e12)
    assert flops.peaks("some other card") is None


def test_idle_share_and_mfu_read_the_traced_stretch_alone(model):
    from portbench import readers

    forward = flops.dit_forward(model, 1, 4096, 4096)
    t = {"chips": 1, "model": model,
         "peaks": flops.peaks("NVIDIA H100 80GB HBM3"),
         "traces": [{"summary": {"busy_s": 0.9, "window_s": 1.2}, "images": 1,
                     "forwards": [(1, 4096, 4096, 0, True)]}]}
    assert readers.idle_share(t) == pytest.approx(25.0)
    assert readers.mfu(t) == pytest.approx(100 * forward / (1.2 * 989e12))
    t["traces"][0]["summary"]["busy_s"] = 0.0
    assert readers.idle_share(t) is None and readers.mfu(t) is None
