"""The control (the reference in TF32 in the program's place) and the
half-batch fault come out not correct at each cell's own size, on three
seeds. Needs the card."""

from __future__ import annotations

import pytest

from portbench import control, core

CELLS = ["p2igan_stis_gan.train_b12", "dk_stis.train_b12", "p2igan_stis_gan.serve_archive"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
def test_control_fails_the_limits(card, cell, seed):
    c = core.load_cell(cell)
    reading = control.readings(c, seed, card)
    for kind in ("control", "half_batch"):
        if kind in reading:
            assert control.fails(reading[kind], reading["limits"]), (kind, reading)
