"""A run with the timed path broken underneath must come out not correct,
and the control must read well above the program: each cell's whole
harness (``run.execute``, past the look for a chip) at a small size on
the CPU, in the cell's own precision and against the cell's own limits
(the control three times the program or more at this size; against the
limits it is held at the cells' own size on the card, in
``test_portbench_card.py``).

Faults, where the cell can have them: a denoising step that returns its
state unchanged; the exchange between the ranks left out (each rank sees
its own rows everywhere; the spmd cell); the output of half the lanes of
a served batch lost (the serving cells); an image altered where it is
produced.
"""
import sys
import types

import pytest
import torch

import test_portbench_faults as this
from conftest import PROMPT, execute, load_run, tiny_context

#: the one-chip cells, and the prompt path that no cell runs yet
CELLS = ["sdxl-dit.generate", "sdxl-dit.serve-poisson", PROMPT]
#: an open loop fast enough at the small size that lanes share dispatches
BUSY = {"sdxl-dit.serve-poisson": {"mix": {"rate_per_s": 40.0}}}


def run(cell, seconds=2.0, **over):
    return execute(tiny_context(cell, seconds=seconds, **BUSY.get(cell, {}),
                                **over))


def unchanged_state(monkeypatch):
    from repro_torch.core import sampler
    monkeypatch.setattr(sampler, "ddim_step", lambda sched, x, *a, **k: x)


def half_batch(monkeypatch):
    from repro_torch.models.diffusion import dit

    fn = dit.forward_patch

    def forward(*a, **k):
        eps, kv = fn(*a, **k)
        B = eps.shape[0]
        if B > 1:                       # the second half's output lost
            eps = eps.clone()
            eps[B // 2:] = 0
        return eps, kv
    monkeypatch.setattr(dit, "forward_patch", forward)


def altered_answer(monkeypatch):
    from repro_torch.core.pipeline import StadiPipeline
    from repro_torch.serving import diffusion_engine as eng

    gen = StadiPipeline.generate

    def generate(self, *a, **k):
        res = gen(self, *a, **k)
        res.image = res.image.clone()
        res.image[:, :2] = 0
        return res
    monkeypatch.setattr(StadiPipeline, "generate", generate)
    step = eng.DiffusionServingEngine.step

    def serve_step(self):
        done = step(self)
        for r in done:
            r.image = r.image.clone()
            r.image[:, :2] = 0
        return done
    monkeypatch.setattr(eng.DiffusionServingEngine, "step", serve_step)


FAULTS = {"unchanged_state": unchanged_state,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS[1:])
def test_half_the_lanes_left_out_is_not_correct(cell, monkeypatch):
    half_batch(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_well_above_the_program(cell):
    from portbench import harness
    import importlib

    ctx = tiny_context(cell, seconds=2.0, **BUSY.get(cell, {}))
    driver = importlib.import_module(f"portbench.drivers.{ctx.spec['driver']}")
    prog, ctrl = driver.run(ctx)["readings"](True)
    assert ctrl["image_rel_err"] >= 3 * prog["image_rel_err"], (prog, ctrl)
    assert not harness.forbidden_modules()


# -- the spmd cell on four CPU ranks (gloo) ---------------------------------

def _rank_without_exchange(rank_ctx, ctx):
    """A rank whose all-gathers return its own rows in every rank's
    place."""
    from repro_torch.core import comm
    from portbench.drivers import generate

    def gather(x_local, sizes, group=None, axis=0):
        return torch.cat([x_local.narrow(axis, 0, s) for s in sizes], dim=axis)
    comm.uneven_all_gather_padded = gather
    return generate._rank(rank_ctx, ctx)      # this process's, unpatched


def test_spmd_sound_and_without_exchange(monkeypatch):
    from portbench.drivers import generate

    out = run("sdxl-dit.spmd4", seconds=1.0)
    assert out["correct"], out["checks"]
    assert out["forbidden"] == []
    monkeypatch.setattr(generate, "_rank", this._rank_without_exchange)
    out = run("sdxl-dit.spmd4", seconds=1.0)
    assert not out["correct"], out["checks"]


# -- a forbidden module loaded where the window runs ------------------------

def _plant(name):
    """Load an empty stand-in module of this name in this process."""
    sys.modules.setdefault(name, types.ModuleType(name))
    return name


class _Planted:
    """Loads an empty module ``name`` in the process that unpickles it: a
    rank, which unpickles its context, and not the process that spawned
    it."""

    def __init__(self, name):
        self.name = name

    def __reduce__(self):
        return this._plant, (self.name,)


def test_a_forbidden_module_in_a_rank_is_found():
    out = run("sdxl-dit.spmd4", seconds=1.0, planted=_Planted("jax"))
    assert out["forbidden"] == ["jax"]
    assert "jax" not in sys.modules


def test_no_result_where_a_forbidden_module_was_found(monkeypatch, capsys):
    run_py = load_run()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run_py, "execute",
                        lambda ctx: {"correct": True, "forbidden": ["jax"]})
    rc = run_py.main(["--workload", "sdxl-dit.spmd4", "--seed", "1",
                      "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "jax" in err
