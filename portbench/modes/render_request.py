"""``render_request``: the port's batched render (``models/shader.py``'s
``shader_forward`` or ``models/texture_face.py``'s
``texture_face_forward``, under ``torch.no_grad``), as the render CLI runs
it: a closed loop with one client. A request is one shape at ``views``
poses (and one texture code); it is timed from its submission until its
images are on the host.

The check takes a sample of the window's requests, drawn from the seed
(reservoir sampling over every request served), and renders each again
with the reference.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare, traffic, work
from portbench.modes import _common
from portbench.reference import nets, warp


class Reservoir:
    """``k`` of the offered items, each as likely as any other, drawn from
    the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng(np.random.SeedSequence([int(seed), 6]))

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Mode:
    kind = "render"

    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        self.cell, self.cfg, self.seed, self.dev = cell, cfg, int(seed), torch.device(device)
        tr = cell["mix"]
        self.views = tr["views"]
        self.frames_per_unit = self.views
        self.dtype = cell["compute_dtype"]
        self.shader = cfg["model"] == "shader"

    def setup(self) -> None:
        cfg, tr = self.cfg, self.cell["mix"]
        clock = _common.Phases(self.dev)
        _common.set_routes(self.cell.get("route", {}))
        if self.dev.type == "cuda":
            from rendernet_tpu_torch.ops import _native

            _native.build_all()
        clock.mark("build")
        self.pool = traffic.Pool(tr, cfg, self.seed, self.dev)
        self.max_requests = tr["max_requests"]
        self.table = self.pool.request_table(self.max_requests + tr["warmup_requests"], self.views)
        clock.mark("inputs")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.net, _ = _common.build_net(cfg, self.seed, self.dev, clock)
        if self.shader:
            from rendernet_tpu_torch.models.shader import shader_forward as fwd
        else:
            from rendernet_tpu_torch.models.texture_face import texture_face_forward as fwd
        self.forward = fwd
        clock.mark("program")
        for i in range(tr["warmup_requests"]):
            self.serve(self.max_requests + i)
        clock.mark("warmup")
        self.setup_phases = clock.seconds
        self.sample = Reservoir(tr["sample_requests"], self.seed)
        self.n = 0

    def inputs(self, i: int):
        t = self.table
        vox = self.pool.vox.index_select(0, t["shape"][i:i + 1])
        vox = vox.expand(self.views, *vox.shape[1:])
        poses = self.pool.poses.index_select(0, t["poses"][i])
        codes = None
        if not self.shader:
            codes = self.pool.codes.index_select(0, t["code"][i:i + 1])
            codes = codes.expand(self.views, codes.shape[1])
        return vox, poses, codes

    def serve(self, i: int):
        """Request ``i``: its images, on the host."""
        vox, poses, codes = self.inputs(i)
        kw = dict(compute_dtype=_common.DTYPES[self.dtype], resample=self.cell["resample"])
        with torch.no_grad():
            if self.shader:
                return (self.forward(self.net, vox, poses, **kw).cpu(),)
            albedo, normal = self.forward(self.net, vox, codes, poses, **kw)
            return albedo.cpu(), normal.cpu()

    def window(self, seconds: float) -> dict:
        lat = []
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            if ts - t0 >= seconds:
                break
            i = self.n % self.max_requests
            out = self.serve(i)
            lat.append(time.perf_counter() - ts)
            self.sample.offer((i, out))
            self.n += 1
        dt = time.perf_counter() - t0
        k = len(lat)
        return {"units": k, "seconds": dt,
                "metrics": {"render_frames_per_s": (k * self.views / dt, "frames/s"),
                            "render_p95_ms": (float(np.percentile(lat, 95)) * 1e3, "ms")}}

    def stretch(self, units: int) -> None:
        for _ in range(units):
            self.serve(self.n % self.max_requests)
            self.n += 1

    def flops_per_unit(self) -> dict:
        n = self.cfg["new_size"]
        layers = work.shader_layers(self.cfg, self.views, n) if self.shader else \
            work.texface_layers(self.cfg, self.views, n, train=False)
        return work.step_flops(layers, train=False)

    def release(self) -> None:
        self.net = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----
    def reference_images(self, i: int, p, quant=None):
        """Request ``i`` rendered by the reference with weights ``p``; with
        ``quant``, by the control."""
        cfg, n = self.cfg, self.cfg["new_size"]
        q = quant or (lambda t: t)
        vox, poses, codes = self.inputs(i)
        with torch.no_grad():
            cam = warp.camera_warp(vox, poses, n, quant=quant)
            if self.shader:
                return (nets.shader_net(p, cam, cfg, q).cpu(),)
            tex_cam = warp.camera_warp(nets.texture_decoder(p, codes, cfg, q), poses, n,
                                       quant=quant)
            return tuple(o.cpu() for o in nets.texface_net(p, torch.cat([cam, tex_cam], -1),
                                                           cfg, q))

    def _numbers(self, served, p) -> dict:
        return compare.image_numbers([(o, r) for i, out in served
                                      for o, r in zip(out, self.reference_images(i, p))])

    def check(self) -> dict:
        p = _common.make_weights(self.cfg, self.seed, self.dev)
        return self._numbers(self.sample.items, p)

    def control(self, quant) -> dict:
        """The control in the program's place on the sampled requests."""
        p = _common.make_weights(self.cfg, self.seed, self.dev)
        return self._numbers([(i, self.reference_images(i, p, quant))
                              for i, _ in self.sample.items], p)
