"""On the card, at each cell's own size: the control (the reference in fp8
in the program's place) comes out as not correct on three seeds, and the
program as correct. Run with ``python -m pytest portbench/tests -m card``
on a machine with a card; it skips without one."""
import pytest

from portbench import registry

CELLS = [w["name"] for w in registry.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card):
    from portbench import control

    for seed in (101, 2 ** 31 + 103, 107):
        r = control.run_seed(name, seed, 2.0)
        assert r["program_correct"], r
        assert not r["control_correct"], r
