"""The control: the plain reference at the next lower precision, put in
the program's place, fails every cell; the same path at the stated
precision passes."""

import pytest

from portbench import control
from portbench.reference.check import passed
from portbench.tests.tiny import CELLS, SEED, tiny_cell

from portbench import harness


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_every_cell(name, monkeypatch):
    cell = tiny_cell(name)
    state = harness.module("builders", cell.config["builder"]).build(cell.config, SEED, "cpu")
    try:
        checks = control.control_checks(cell, state, "cpu")
        assert not passed(checks)
        assert checks["mismatched_elements"]["value"] > 0 and checks["max_abs_err"]["value"] > 0
        # the same path without the lower precision passes
        monkeypatch.setattr(control, "lowered", lambda t, name: t)
        assert passed(control.control_checks(cell, state, "cpu"))
    finally:
        state.close()
