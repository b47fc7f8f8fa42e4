"""One inverse-rendering step through the multipass warp, the port's plain
K1/K4 passes against JAX's Pallas passes in interpret mode, on the CPU.

The multipass warp embeds the 64^3 decoder grids in the camera grid, so the
grid is 64^3 here (the exact-warp tests in ``tests/test_torch_recon.py`` run
at 32^3). Same numpy weights on both sides; fp32.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rendernet_tpu.recon import inverse as jinv
from rendernet_tpu_torch.recon import inverse as tinv
from test_torch_recon import CFG_J, CFG_T, close_latents, recon_models, target_image

torch.set_num_threads(2)


def test_multipass_recon_step_matches_jax():
    """Per-sample losses to 1e-4 relative (as the exact path's); the latent
    gradients of every group, the pose's through K4's position cotangents
    and the pass plan's coefficients, to 1e-2 of the group's largest entry:
    at this size a random normal head's output sits near 0.5, where Phong's
    normalisation of image - 0.5 (lengths down to 1.5e-4) magnifies fp32
    summation differences. The same comparison on the exact warp at 64^3
    reads 4e-3 (vector, texture) and 9e-3 (pose); this one 2.3e-3, 2.1e-3
    and 6.4e-4. The port's make_recon_step from the same latents against
    JAX's gradient step, as in test_torch_recon.close_latents with the
    gradients' tolerance."""
    kw = dict(resample="multipass", new_size=64)
    cfg_j, cfg_t = dataclasses.replace(CFG_J, **kw), dataclasses.replace(CFG_T, **kw)
    jm, tm = recon_models(64)
    target = target_image(256, seed=9)
    lat0 = jinv.initial_latents(cfg_j, seed=4)

    def jloss(lat):
        per = jinv.recon_per_sample_loss(jm, lat, jnp.asarray(target), cfg_j)
        return jnp.sum(per), per

    (_, jper), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(lat0)
    leaves = [torch.from_numpy(np.array(x, np.float32)).requires_grad_() for x in lat0]
    tper = tinv.recon_per_sample_loss(tm, tinv.Latents(*leaves), torch.from_numpy(target), cfg_t)
    tgrad = torch.autograd.grad(tper.sum(), leaves)
    np.testing.assert_allclose(tper.detach().numpy(), np.asarray(jper), rtol=1e-4)
    for name, gt, gj in zip(tinv.Latents._fields, tgrad, jgrad):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0, name
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-2 * np.abs(gj).max(), rtol=0,
                                   err_msg=name)
    etas = (cfg_j.shape_eta, cfg_j.pose_eta, cfg_j.tex_eta, cfg_j.light_eta)
    jnew = [np.asarray(x) - eta * np.asarray(g) for x, eta, g in zip(lat0, etas, jgrad)]
    tnew, _ = tinv.make_recon_step(tm, cfg_t)(
        tinv.Latents(*(torch.from_numpy(np.array(x, np.float32)) for x in lat0)),
        torch.from_numpy(target))
    close_latents(tnew, jnew, lat0, rel=1e-2)
