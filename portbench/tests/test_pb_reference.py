"""The plain reference against the port on the CPU at a small size: the
render forward of each configuration, and the first training steps (loss,
first gradient, change) of each, both in float32, where the two should
agree to rounding; and the parameter names and shapes of each
configuration at its published widths."""
import pytest
import torch

from portbench import registry
from portbench.modes import _common

from . import tiny


def _mode(name, seed=4, dtype="float32"):
    cell = {**registry.workload(name), **tiny.cell(name, dtype)}
    cfg = {**registry.config(cell["config"]), **tiny.cfg(name)}
    return registry.mode(cell["mode"])(cell, cfg, seed, "cpu")


@pytest.mark.parametrize("name", ["shader.render.bf16.b8", "texface.render.bf16.b8"])
def test_forward_matches_port(name):
    m = _mode(name)
    m.setup()
    m.window(0.2)
    m.release()
    numbers = m.check()
    assert numbers["image_gap"] < 1e-5 and numbers["image_rel"] < 1e-3, numbers


@pytest.mark.parametrize("name", ["shader.train.bf16.b24p64", "texface.train.bf16.b24p64"])
def test_training_steps_match_port(name):
    m = _mode(name)
    m.setup()
    m.release()
    numbers = m.check()
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4, numbers
    assert numbers["change_gap"] < 1e-3, numbers


@pytest.mark.parametrize("config", ["shader", "texface"])
def test_parameter_names_and_shapes(config):
    cfg = registry.config(config)
    mcfg = _common.model_config(cfg)
    if config == "shader":
        from rendernet_tpu_torch.models.shader import ShaderRenderNet as N
    else:
        from rendernet_tpu_torch.models.texture_face import TextureFaceRenderNet as N
    with torch.device("meta"):
        net = N(mcfg, torch.Generator())
    port = {k: tuple(p.shape) for k, p in net.named_parameters()}
    assert port == _common.shapes_of(cfg)
    if config == "shader":
        assert sum(torch.Size(s).numel() for s in port.values()) == 237_270_425
