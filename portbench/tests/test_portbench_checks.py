"""The harness's `correct` at a tiny size on the CPU, with the cells'
own limits (`checks/<cell>.json`): the program passes; each fault a cell
can have, planted underneath the timed path, fails it; and the control,
the reference at the next precision down in the program's place, fails it.
The card's look is skipped; the rest of a run is driven as on the card."""

import pytest

from portbench.tests.tiny import tiny_cell
from portbench import run
from portbench.bench import spec

CELLS = ["pretrain.fr-small", "serve-backlog.flan-xl", "serve-prompt.flan-xl"]
FAULTS = {"pretrain.fr-small": ["unchanged", "half_batch"],
          "serve-backlog.flan-xl": ["token"],
          "serve-prompt.flan-xl": ["token"]}
# the tiny backlog runs dry in a second or two: a window longer than that
# judges the same requests however slow the machine
SECONDS = {"serve-backlog.flan-xl": 60.0}


def _run(name, fault=None):
    ctx = run.execute(run.Args(name, seed=2 ** 33 + 5,
                               seconds=SECONDS.get(name, 0.5)),
                      device="cpu", cell=tiny_cell(name), fault=fault)
    line = run.result_line(ctx)
    assert list(line)[-1] == "checks"
    return ctx, line


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    ctx, line = _run(name)
    assert line["correct"], ctx.checks
    assert ctx.attempted > 0 and ctx.failed == 0


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_is_not_correct(name, fault):
    ctx, line = _run(name, fault)
    assert not line["correct"], ctx.checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    drv = spec.driver(cell.traffic["driver"])
    ctx = run.Context(cell, 2 ** 33 + 6, SECONDS.get(name, 0.5), 0, "cpu")
    drv.control(ctx, drv.CONTROL)
    assert not ctx.correct, ctx.checks


def _closed_early(fault=None):
    """The backlog cell with its window closed after the first decode
    window of 8 steps, every budget longer: all 4 slots still in flight."""
    cell = tiny_cell("serve-backlog.flan-xl")
    cell.traffic["engine"]["steps_per_sync"] = 8
    cell.traffic["requests"]["new_tokens"] = {"uniform": [12, 30]}
    return run.execute(run.Args(cell.name, seed=2 ** 33 + 7, seconds=0.0),
                       device="cpu", cell=cell, fault=fault)


def test_requests_in_flight_at_the_close_are_judged():
    ctx = _closed_early()
    r = ctx.readings
    assert r["finished"] == 0 and r["in_flight"] == 4
    assert r["sampled_running"] == 4 and r["tokens_judged"] == 4 * 8
    assert r["longest_judged"] == 8
    assert ctx.correct, ctx.checks


def test_a_token_altered_in_flight_is_not_correct():
    ctx = _closed_early("token")
    assert ctx.readings["finished"] == 0
    assert not ctx.correct, ctx.checks
