"""On the card, at each one-chip cell's own size: a short window of the
program reads within the cell's limits and the control (the reference in
float8) reads beyond them. Marked ``cuda``; skips without a card."""
import importlib
import time

import pytest

CELLS = ["sdxl-dit.generate", "sdxl-dit.serve-poisson"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_beyond_the_limits(cell, card):
    from portbench import correct, harness

    ctx = harness.new_context(cell, 2**31 + 77, 6.0, False, card,
                              time.perf_counter())
    driver = importlib.import_module(f"portbench.drivers.{ctx.spec['driver']}")
    prog, ctrl = driver.run(ctx)["readings"](True)
    limits = ctx.spec["check"]["limits"]
    assert correct.verdict(prog, limits), prog
    assert not correct.verdict(ctrl, limits), ctrl
