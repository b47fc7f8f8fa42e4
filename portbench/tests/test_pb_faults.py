"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the port on the CPU at a small size, in float32,
where the sound run agrees with the reference to rounding, and the whole
run (set-up, window, check) is driven through ``run.main`` without the
look for a card, at the cells' own limits: a step that returns its state
unchanged; half of the batch left out and the mean taken over the rest; an
answer altered where it is produced (a step's loss, a served image)."""
import json

import pytest

from portbench import faults, run

from . import tiny

TRAIN = ["shader.train.bf16.b24p64", "texface.train.bf16.b24p64"]
RENDER = ["shader.render.bf16.b8", "texface.render.bf16.b8"]


def _run(name, capsys) -> dict:
    rc = run.main(["--workload", name, "--seed", str(2 ** 31 + 11), "--seconds", "0.3"],
                  device="cpu", cell_override=tiny.cell(name), cfg_override=tiny.cfg(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_sound_run_is_correct(name, capsys):
    assert _run(name, capsys)["correct"]


@pytest.mark.parametrize("fault", faults.TRAIN)
@pytest.mark.parametrize("name", TRAIN)
def test_training_fault_is_caught(name, fault, monkeypatch, capsys):
    faults.plant("train", name.split(".")[0], fault, monkeypatch.setattr)
    out = _run(name, capsys)
    assert not out["correct"], out


@pytest.mark.parametrize("fault", faults.RENDER)
@pytest.mark.parametrize("name", RENDER)
def test_render_fault_is_caught(name, fault, monkeypatch, capsys):
    faults.plant("render", name.split(".")[0], fault, monkeypatch.setattr)
    out = _run(name, capsys)
    assert not out["correct"], out
