"""The check that decides ``correct`` fails what it must: a run with its timed
path broken underneath, by each fault its generator lists for its traffic,
and the generator's control put in the program's place, come out not
correct. On the CPU, at a small size, with limits at three times what the
sound program reads at that size and seed (the cells' own limits are set on
the card, at the cells' sizes, PERF.md section 2)."""

import pytest

from tnbench import readings, run
from tnbench.tests import cells

BENCH = cells.BENCH
CPU = cells.CPU
SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell, fault", cells.fault_cases())
def test_fault_is_not_correct(cell, fault):
    c = cells.with_sound_limits(cell, SEED)
    with readings.planted(cells.generator(c), c["traffic"], fault):
        out = run.run_cell(BENCH, cell, SEED, 0.2, False, CPU, 0.0, loaded=c)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("cell", cells.CELLS)
def test_control_is_not_correct(cell):
    c = cells.with_sound_limits(cell, SEED)
    got = cells.generator(c).control(c["config"], c["traffic"], SEED, CPU, 0.2)
    assert not run.judge(got["numbers"], c["limits"])[0]
