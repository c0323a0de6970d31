"""The benchmark's own tests (run them with ``python -m pytest -q
portbench/tests``): the repository's test run collects ``tests/`` only.
Cases that need the card are marked ``cuda`` and skip without one; the
rest run a cell's whole harness on the CPU at a small size."""
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

#: a cell's configuration cut to a size a CPU test holds: 64 tokens, two
#: blocks of width 64
TINY = {"latent_size": 16, "n_layers": 2, "d_model": 64, "n_heads": 4,
        "cond_dim": 32, "n_classes": 16}


#: the prompt path (the text tower, the prompt read, a lane group a prompt
#: bucket), which no cell of BENCHMARK.json runs: the serving cell's file
#: with a cross-attending model, the closed-loop prompt mix, and the limits
#: that path was held to on the card at a 256-wide tower and 32 tokens
PROMPT = "prompt-path"


def _prompt_path():
    with open(os.path.join(ROOT, "portbench", "traffic", "serve-closed.json")) as f:
        mix = json.load(f)
    mix.pop("classes")              # the small size's classes, as a cell's
    return "sdxl-dit.serve-poisson", {
        "model": {"cross_attn": True, "cond_seq_len": 32}, "mix": mix,
        "traffic": "serve-closed",
        "check": {"samples": 3, "limits": {"plan_mismatch": 0,
                                           "image_rel_err": 0.045,
                                           "tokens_rel_err": 1e-05}}}


def tiny_context(cell, seed=2**31 + 5, seconds=2.0, trace=False, **over):
    """A cell (or :data:`PROMPT`) at the small size, ``over`` merged into
    its file."""
    from portbench import harness

    if cell == PROMPT:
        cell, path = _prompt_path()
        for key in ("model", "mix"):
            over[key] = {**path.pop(key), **over.get(key, {})}
        over = {**path, **over}
    model = dict(TINY, **over.pop("model", {}))
    spec_over = {"model": model, "mix": {"classes": 16, **over.pop("mix", {})},
                 **over}
    return harness.new_context(cell, seed, seconds, trace, "cpu",
                               time.perf_counter(), spec_over)


def load_run():
    """``portbench/run.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(ROOT, "portbench", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return run


def execute(ctx):
    """run.py's whole path after the look for a chip."""
    return load_run().execute(ctx)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
