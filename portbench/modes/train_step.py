"""``train_step``: the port's training step (``train/steps.py``'s
``make_shader_train_step`` / ``make_texture_train_step`` with
``train/optim.py``'s ``make_optimizer``), dispatched back to back.

Set-up builds one training state from the seed's weights and drives it
through its first ``follow_steps`` steps, through the same call and feed as
the window, on rows that all differ; the window then goes on with that
state. The reference follows those first steps from the same weights and
inputs: each step's loss, the first gradient as the optimizer holds it
after one step (Adam's first moment is (1 - b1) g), and the parameters'
change after the last step followed.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare, traffic, work
from portbench.modes import _common
from portbench.reference import nets, train as ref_train, warp


def _adam_mu(opt_state):
    """The first-moment dict of the optimizer's state (a tuple of states)."""
    stack = [opt_state]
    while stack:
        s = stack.pop()
        if hasattr(s, "mu"):
            return s.mu
        if isinstance(s, tuple):
            stack.extend(s)
    raise ValueError("no Adam state (mu) in the optimizer state")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Mode:
    kind = "train"

    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        self.cell, self.cfg, self.seed, self.dev = cell, cfg, int(seed), torch.device(device)
        tr = cell["mix"]
        self.batch, self.patch = tr["batch"], tr["patch"]
        self.follow = tr["follow_steps"]
        self.frames_per_unit = self.batch
        self.dtype = cell["compute_dtype"]
        self.shader = cfg["model"] == "shader"
        self.rng = self.seed & 0xFFFFFFFF

    # ---- the program ----
    def setup(self) -> None:
        from rendernet_tpu_torch.train.optim import make_optimizer
        from rendernet_tpu_torch.train.steps import (TrainState, make_shader_train_step,
                                                     make_texture_train_step)

        cfg, tr = self.cfg, self.cell["mix"]
        clock = _common.Phases(self.dev)
        _common.set_routes(self.cell.get("route", {}))
        if self.dev.type == "cuda":
            from rendernet_tpu_torch.ops import _native

            _native.build_all()
        clock.mark("build")
        self.pool = traffic.Pool(tr, cfg, self.seed, self.dev)
        self.rows = self.pool.row_table(tr["max_steps"], self.batch)
        # each step's crop offsets (u0, v0) in the camera grid
        off = np.random.default_rng(np.random.SeedSequence([self.seed, 5]))
        self.offsets = [tuple(int(v) for v in o) for o in
                        off.integers(0, cfg["new_size"] - self.patch + 1, (tr["max_steps"], 2))]
        clock.mark("inputs")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        net, mcfg = _common.build_net(cfg, self.seed, self.dev, clock)
        tcfg = _common.train_config(cfg, self.cell)
        tx = make_optimizer(tcfg.e_eta, tcfg.decay_steps, tcfg.decay_rate,
                            moment_dtype=tcfg.moment_dtype)
        self.state = TrainState(net, tx.init(dict(net.named_parameters())))
        make = make_shader_train_step if self.shader else make_texture_train_step
        self.step_fn = make(mcfg, tcfg, tx, self.patch)
        self.n = 0
        clock.mark("program")
        b1 = cfg["train"]["b1"]
        self.losses = []
        for t in range(self.follow):
            self.losses.append(self.run_step())
            if t == 0:
                self.grad_norms = {k: (m.float() / (1.0 - b1)).double().norm()
                                   for k, m in _adam_mu(self.state.opt_state).items()}
        clock.mark("first_steps")
        p0 = _common.make_weights(cfg, self.seed, self.dev)
        with torch.no_grad():
            self.change_norms = {k: (p - p0[k]).double().norm()
                                 for k, p in net.named_parameters()}
        del p0
        clock.mark("readings")
        self.setup_phases = clock.seconds

    def run_step(self) -> torch.Tensor:
        i = self.n % len(self.rows)
        b = self.pool.train_batch(self.rows[i])
        if self.shader:
            self.state, loss = self.step_fn(self.state, b["voxels"], b["images"], b["poses"],
                                            self.rng, offsets=self.offsets[i])
        else:
            self.state, loss = self.step_fn(self.state, b["voxels"], b["images"], b["normals"],
                                            b["codes"], b["poses"], self.rng,
                                            offsets=self.offsets[i])
        self.n += 1
        return loss

    def window(self, seconds: float) -> dict:
        _sync(self.dev)
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            self.run_step()
            k += 1
        _sync(self.dev)
        dt = time.perf_counter() - t0
        return {"units": k, "seconds": dt,
                "metrics": {"train_frames_per_s": (k * self.batch / dt, "frames/s")}}

    def stretch(self, units: int) -> None:
        for _ in range(units):
            self.run_step()
        _sync(self.dev)

    def flops_per_unit(self) -> dict:
        layers = work.shader_layers(self.cfg, self.batch, self.patch) if self.shader else \
            work.texface_layers(self.cfg, self.batch, self.patch, train=True)
        return work.step_flops(layers, train=True)

    def release(self) -> None:
        self.state = self.step_fn = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----
    def program_readings(self) -> ref_train.Readings:
        return ref_train.Readings([float(v) for v in self.losses],
                                  {k: float(v) for k, v in self.grad_norms.items()},
                                  {k: float(v) for k, v in self.change_norms.items()})

    def reference_readings(self, quant=None) -> ref_train.Readings:
        """The reference's readings over the steps set-up ran; with
        ``quant`` the control's (``reference/quant.py``)."""
        cfg, n, f, patch = self.cfg, self.cfg["new_size"], self.cfg["image_factor"], self.patch
        q = quant or (lambda t: t)

        def crop(img, u, v):
            return img[:, f * u:f * (u + patch), f * v:f * (v + patch)].float() / 255.0

        def loss_of(p, t, rows):
            b = self.pool.train_batch(self.rows[t][rows])
            u, v = self.offsets[t]
            with torch.no_grad():
                cam = warp.camera_warp(b["voxels"], b["poses"], n, (u, v), patch, quant=quant)
            if self.shader:
                return ref_train.bce_loss(nets.shader_net(p, cam, cfg, q),
                                          crop(b["images"], u, v))
            tex = nets.texture_decoder(p, b["codes"], cfg, q)
            tex_cam = warp.camera_warp(tex, b["poses"], n, (u, v), patch, quant=quant)
            albedo, normal = nets.texface_net(p, torch.cat([cam, tex_cam], -1), cfg, q)
            return (ref_train.mse_loss(albedo, crop(b["images"], u, v))
                    + ref_train.mse_loss(normal, crop(b["normals"], u, v)))

        p0 = _common.make_weights(cfg, self.seed, self.dev)
        return ref_train.follow(p0, self.follow, self.batch, self.cell["reference_chunk"],
                                loss_of, cfg["train"])

    def check(self) -> dict:
        return compare.train_numbers(self.program_readings(), self.reference_readings())

    def control(self, quant) -> dict:
        return compare.train_numbers(self.reference_readings(quant), self.reference_readings())
