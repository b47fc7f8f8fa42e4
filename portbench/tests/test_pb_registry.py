"""The harness finds every configuration, cell, mode and metric by name,
and a cell is added by adding one file."""
import json
import shutil

import pytest

from portbench import registry, run

from . import tiny


def test_finds_every_file():
    bench = registry.manifest()
    assert set(registry.names("workloads")) == {w["name"] for w in bench["workloads"]}
    assert set(registry.names("configs")) == {c["name"] for c in bench["configs"]}
    assert {"train_step", "render_request"} <= set(registry.names("modes"))
    for fam in registry.names("metrics"):
        assert callable(registry.metric_reader(fam)[0])
    with pytest.raises(KeyError):
        registry.workload("no.such.cell")
    with pytest.raises(ValueError):
        registry.workload("../BENCHMARK")


def test_a_new_file_is_a_new_cell(tmp_path, monkeypatch, capsys):
    for d in ("workloads", "configs", "modes", "metrics", "reference"):
        shutil.copytree(registry.HERE / d, tmp_path / d)
    old = registry.workload("shader.render.bf16.b8")
    new = {**old, "mix": {**old["mix"], "views": 4}}
    (tmp_path / "workloads" / "shader.render.bf16.b4.json").write_text(json.dumps(new))
    monkeypatch.setattr(registry, "HERE", tmp_path)
    assert "shader.render.bf16.b4" in registry.names("workloads")
    rc = run.main(["--workload", "shader.render.bf16.b4", "--seed", "3", "--seconds", "0.5"],
                  device="cpu", cell_override=tiny.cell("shader.render.bf16.b8", views=4),
                  cfg_override=tiny.cfg("shader.render.bf16.b8"))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] and set(out["metrics"]) == {"setup_s"}
