"""No module a run loads has the whole top-level name jax, jaxlib, flax or
rendernet_tpu, and the reference (with the yardstick around it) loads
nothing of the port."""
import json
import subprocess
import sys

from portbench import registry

BANNED = ("jax", "jaxlib", "flax", "rendernet_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=registry.ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_port():
    top = _loaded("import portbench.reference.nets, portbench.reference.warp, "
                  "portbench.reference.train, portbench.reference.quant, portbench.weights, "
                  "portbench.traffic, portbench.work, portbench.compare, portbench.trace")
    assert not top & {*BANNED, "rendernet_tpu_torch"}


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv = ['x']\n"
            "from portbench import run\n"
            "from portbench.tests import tiny\n"
            "c = 'texface.train.bf16.b24p64'\n"
            "rc = run.main(['--workload', c, '--seed', '5', '--seconds', '0.3', '--trace', '1'],"
            " device='cpu', cell_override=tiny.cell(c, follow_steps=1),"
            " cfg_override=tiny.cfg(c))\n"
            "assert rc == 0 and run.loaded_banned() == []")
    top = _loaded(code)
    assert "rendernet_tpu_torch" in top and not top & set(BANNED)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "rendernet_tpu_torch_x", sys)
    assert run.loaded_banned() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.loaded_banned() == ["jax"]
