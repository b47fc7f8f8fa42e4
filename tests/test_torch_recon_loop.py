"""The port's coarse-to-fine reconstruction loop and ``reconstruct`` CLI, on
the CPU.

A 2-epoch ``reconstruct`` with the pattern-search options against the JAX
package's (same numpy weights, through ``compat.jax_params``; see
``tests/test_torch_recon.py``), and a run of the port's ``reconstruct`` CLI
with seeded random weights on targets it renders itself. Tolerances are
stated per test.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.recon import inverse as jinv
from rendernet_tpu_torch.recon import inverse as tinv
from test_torch_recon import CFG_J, CFG_T, close_latents, recon_models, target_image

torch.set_num_threads(2)


def test_reconstruct_matches_jax():
    """Two epochs of 3 steps with halve_mode="on_center" and
    sequence_axes=True (the azimuth-only first box, then the theta box opens
    on a center win), callbacks on: the [2, 5] final losses and [2, 3, 5]
    curves to 1e-4 relative (a loss averages the composite's squared error,
    whose few mask-magnified pixels, see test_recon_forward_matches_jax,
    move it by up to ~3e-5 relative; the hypotheses' losses lie ~3e-3
    apart, so the same one wins each epoch on both sides), the callbacks'
    epochs and winners, and the final latents as in
    test_torch_recon.close_latents."""
    jm, tm = recon_models(32)
    kw = dict(halve_mode="on_center", sequence_axes=True)
    cfg_j, cfg_t = dataclasses.replace(CFG_J, **kw), dataclasses.replace(CFG_T, **kw)
    target = target_image(128, seed=8)
    seen = {"jax": [], "port": [], "inner": []}
    jlat, jhist, jcurves = jinv.reconstruct(
        jm, jnp.asarray(target), cfg_j, seed=2,
        callback=lambda e, lat, f: seen["jax"].append((e, int(f.argmin()))))
    tlat, thist, tcurves = tinv.reconstruct(
        tm, torch.from_numpy(target), cfg_t, seed=2, dump_every=3,
        callback=lambda e, lat, f: seen["port"].append((e, int(f.argmin()))),
        inner_callback=lambda e, s, lat, chunk: seen["inner"].append((e, s, chunk.shape)))
    assert thist.shape == (2, 5) and tcurves.shape == (2, 3, 5)
    np.testing.assert_allclose(thist, jhist, rtol=1e-4)
    np.testing.assert_allclose(tcurves, jcurves, rtol=1e-4)
    assert seen["port"] == seen["jax"] and [e for e, _ in seen["port"]] == [0, 1]
    assert seen["inner"] == [(0, 3, (3, 5)), (1, 3, (3, 5))]
    close_latents(tlat, jlat, jinv.initial_latents(cfg_j, seed=2))


def _write_targets(tmp, size):
    """Albedo and normal PNGs rendered by the port itself with seeded random
    weights at a known pose (azimuth 250, elevation 10 degrees)."""
    from rendernet_tpu_torch.models.decoders import (
        init_recon_rendernet_params,
        init_recon_texture_decoder_params,
        init_shape_decoder_params,
    )
    from rendernet_tpu_torch.utils.image import save_image, to_uint8

    cfg = tinv.ReconConfig(new_size=size)
    model = tinv.ReconModel(init_shape_decoder_params(3, device="cpu"),
                            init_recon_texture_decoder_params(4, device="cpu"),
                            init_recon_rendernet_params(5, new_size=size, device="cpu"))
    lat = tinv.initial_latents(dataclasses.replace(cfg, batch_size=1), seed=1, device="cpu")
    lat = lat._replace(pose=torch.tensor([[250 * math.pi / 180, 10 * math.pi / 180, 1.0]]))
    with torch.no_grad():
        _, albedo, normal, _ = tinv.recon_forward(model, lat, cfg)
    paths = []
    for name, img in (("albedo", albedo), ("normal", normal)):
        paths.append(os.path.join(tmp, f"target_{name}.png"))
        save_image(to_uint8(img[0].numpy(), 255.0), paths[-1])
    return paths


def test_reconstruct_cli_smoke(tmp_path):
    """``python -m rendernet_tpu_torch.cli reconstruct <json> --random-weights
    --device cpu --dump-every 1`` on a 32^3 grid, 2 epochs of 2 steps:
    the shaded target, the per-epoch and per-chunk PNG + binvox dumps, one
    metrics line per chunk and finite loss curves."""
    from rendernet_tpu_torch.cli.__main__ import main
    from rendernet_tpu_torch.io.binvox import load_binvox
    from rendernet_tpu_torch.utils.image import decode_image

    albedo, normal = _write_targets(str(tmp_path), 32)
    out = tmp_path / "run"
    cfg = {"batch_size": 5, "inner_step": 2, "max_epochs": 2, "new_size": 32, "img_res": 128,
           "sample_save": str(out), "target_albedo": albedo, "target_normal": normal,
           "target_azimuth_light": 294.0, "target_elevation_light": 105.0}
    cfg_path = tmp_path / "recon.json"
    cfg_path.write_text(json.dumps(cfg))
    assert main(["reconstruct", str(cfg_path), "--random-weights", "--dump-every", "1",
                 "--device", "cpu"]) == 0
    names = sorted(os.listdir(out))
    shaded = decode_image((out / "shaded_target.png").read_bytes())
    assert shaded.shape == (128, 128, 3) and shaded.std() > 0
    for epoch in (0, 1):
        assert f"epoch{epoch}_step1.png" in names and f"epoch{epoch}_step1.binvox" in names
        ends = [n for n in names if n.startswith(f"epoch{epoch}_p") and n.endswith(".png")]
        assert len(ends) == 1
        vox = load_binvox(str(out / ends[0].replace(".png", ".binvox")))
        assert vox.shape == (64, 64, 64)
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [(m["epoch"], m["inner_step"]) for m in lines] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    hist = np.load(out / "loss_history.npz")
    assert hist["final"].shape == (2, 5) and hist["curves"].shape == (2, 2, 5)
    assert np.isfinite(hist["curves"]).all() and np.isfinite(hist["final"]).all()


def test_reconstruct_cli_loads_reference_weight_dirs(tmp_path):
    """The CLI's default path: weight directories written by JAX's
    export_reference_weight_dir (the renderer and texture decoder in one,
    the shape decoder in the other) fill seeded template networks with the
    exported values exactly; a key the directory lacks keeps the
    template's value."""
    from rendernet_tpu.compat.tf_import import export_reference_weight_dir
    from rendernet_tpu_torch.cli.reconstruct import load_reference_weights
    from rendernet_tpu_torch.compat.jax_params import jax_params_from_module
    from rendernet_tpu_torch.models.decoders import (
        init_recon_rendernet_params,
        init_recon_texture_decoder_params,
        init_shape_decoder_params,
    )

    def nets(seeds):
        return tinv.ReconModel(init_shape_decoder_params(seeds[0], z_dim=16, device="cpu"),
                               init_recon_texture_decoder_params(seeds[1], device="cpu"),
                               init_recon_rendernet_params(seeds[2], new_size=32, device="cpu"))

    source, target = nets((7, 8, 9)), nets((0, 1, 2))
    flat = [jax_params_from_module(n) for n in source]
    dropped = "encoder/e_conv1/alpha"
    render_dir, decoder_dir = tmp_path / "render", tmp_path / "decoder"
    export_reference_weight_dir({**flat[1], **{k: v for k, v in flat[2].items() if k != dropped}},
                                str(render_dir))
    export_reference_weight_dir(flat[0], str(decoder_dir))
    kept = target.renderer.state_dict()["encoder.e_conv1.alpha"].clone()
    load_reference_weights(target, str(render_dir), str(decoder_dir))
    for src, dst in zip(source, target):
        for name, value in src.state_dict().items():
            if name == "encoder.e_conv1.alpha":
                torch.testing.assert_close(dst.state_dict()[name], kept, rtol=0, atol=0)
            else:
                torch.testing.assert_close(dst.state_dict()[name], value, rtol=0, atol=0)


def test_reconstruct_cli_needs_a_card_or_cpu(tmp_path, monkeypatch):
    """Without --device the CLI runs on CUDA, and says so where there is none."""
    from rendernet_tpu_torch.cli import reconstruct

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = tmp_path / "recon.json"
    cfg_path.write_text(json.dumps({"new_size": 32, "img_res": 128}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reconstruct.main([str(cfg_path), "--random-weights"])
