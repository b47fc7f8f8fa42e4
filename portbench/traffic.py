"""The traffic generator: every input of a run, made from ``--seed``.

One general generator reads a cell's ``mix`` parameters
(``workloads/<cell>.json``):

* ``shapes``: procedural 64^3 occupancy grids, each a union of random boxes
  and ellipsoids, made on the device;
* ``poses``: (azimuth, elevation, scale) on the reference data's 15 degree
  grid (``data/pose.py:41-48``: name fields times 15 degrees), azimuth
  steps in [0, ``azimuth_steps``), elevation steps in [0,
  ``elevation_steps``), scale 3.3 / radius at the radius 3.3;
* ``texture_codes``: 199-d normal codes (a 3DMM-style texture basis);
* ``pairs``: training samples (shape, pose, code), with their targets,
  which the generator renders itself: the first surface along the camera's
  depth, shaded by depth (greyscale), coloured by position and code
  (albedo) and with the depth map's normal (normals), on a black or white
  background drawn for each pair, as uint8 at 4x the camera grid;
* per step: the rows (pairs, all different); per
  request: one shape, ``views`` different poses and one code. The crop
  offsets of a training step come from the same seed (``modes/train_step.py``).

Every seed gives the same sizes and the same amount of work; only the
contents and their order change.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.warp import camera_warp

DEG15 = 15.0 * math.pi / 180.0


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def shapes(n: int, size: int, seed: int, device) -> torch.Tensor:
    """``[n, size, size, size, 1]`` float32 in {0, 1}: each a union of 3-6
    boxes and ellipsoids with centres in the middle half of the grid."""
    r = _rng(seed, 1)
    prims = 6
    centre = r.uniform(0.3, 0.7, (n, prims, 3)) * size
    half = r.uniform(0.06, 0.22, (n, prims, 3)) * size
    kind = r.integers(0, 2, (n, prims))
    used = np.arange(prims)[None, :] < r.integers(3, prims + 1, (n, 1))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    c, h = t(centre)[:, :, None, None, None, :], t(half)[:, :, None, None, None, :]
    ax = torch.arange(size, dtype=torch.float32, device=device) + 0.5
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)[None, None]
    d = (grid - c).abs() / h
    box = d.amax(-1) <= 1.0
    ell = (d * d).sum(-1) <= 1.0
    inside = torch.where(t(kind)[:, :, None, None, None] > 0, box, ell)
    inside = inside & torch.as_tensor(used, device=device)[:, :, None, None, None]
    return inside.any(1).to(torch.float32)[..., None]


def pose_grid(azimuth_steps: int, elevation_steps: int, device) -> torch.Tensor:
    """``[azimuth_steps * elevation_steps, 3]``: every (azimuth, elevation)
    of the grid at scale 1."""
    a, e = np.meshgrid(np.arange(azimuth_steps), np.arange(elevation_steps), indexing="ij")
    p = np.stack([a.ravel() * DEG15, e.ravel() * DEG15, np.ones(a.size)], -1)
    return torch.as_tensor(p, dtype=torch.float32, device=device)


def texture_codes(n: int, dim: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    return torch.randn(n, dim, generator=gen, device=device)


def _surface(cam: torch.Tensor):
    """(hit mask, depth in [0, 1]) of the first occupied cell along the
    depth axis of a camera grid ``[B, H, W, D, 1]``."""
    occ = cam[..., 0] > 0.5
    d = occ.shape[-1]
    idx = torch.arange(d, device=cam.device).expand_as(occ)
    first = torch.where(occ, idx, d).amin(-1)
    hit = first < d
    return hit, first.to(torch.float32) / d


def _upsample(img: torch.Tensor, f: int) -> torch.Tensor:
    return img.repeat_interleave(f, 1).repeat_interleave(f, 2)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x.clamp(0, 1) * 255).to(torch.uint8)


def render_targets(vox: torch.Tensor, poses: torch.Tensor, codes: torch.Tensor | None,
                   background: torch.Tensor, new_size: int,
                   factor: int) -> Dict[str, torch.Tensor]:
    """uint8 targets of ``B`` samples at ``factor`` x the camera grid:
    ``images`` (greyscale by depth, or with ``codes`` RGB albedo) on a
    ``background`` of 0 or 1 a sample, as renders on black or white, and
    with ``codes`` also ``normals``."""
    cam = camera_warp(vox, poses, new_size)
    hit, depth = _surface(cam)
    hitf = hit.to(torch.float32)
    bg = background.to(torch.float32)[:, None, None] * (1.0 - hitf)
    if codes is None:
        return {"images": _u8(_upsample(((1.0 - 0.8 * depth) * hitf + bg)[..., None], factor))}
    phase = codes[:, :3, None, None]
    u = torch.linspace(0, 1, new_size, device=vox.device)
    base = torch.stack([depth * 5.0, u[None, :, None].expand_as(depth) * 7.0,
                        u[None, None, :].expand_as(depth) * 3.0], 1)
    albedo = (0.5 + 0.45 * torch.sin(base + phase)) * hitf[:, None] + bg[:, None]
    gy, gx = torch.gradient(depth * new_size / 8.0, dim=(1, 2))
    nrm = torch.stack([-gx, -gy, torch.ones_like(gx)], -1)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    nrm = (nrm * 0.5 + 0.5) * hitf[..., None]
    return {"images": _u8(_upsample(albedo.movedim(1, -1), factor)),
            "normals": _u8(_upsample(nrm, factor))}


class Pool:
    """The inputs of one run, on the device."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, device, chunk: int = 16):
        self.traffic, self.seed, self.device = traffic, int(seed), device
        size, n = cfg["voxel_size"], traffic["shapes"]
        self.vox = shapes(n, size, seed, device)
        self.poses = pose_grid(traffic["azimuth_steps"], traffic["elevation_steps"], device)
        self.codes = None
        if cfg["model"] == "texface":
            self.codes = texture_codes(traffic["texture_codes"], cfg["texture_dim"], seed, device)
        if traffic.get("pairs"):
            r = _rng(seed, 2)
            m = traffic["pairs"]
            self.pair_shape = torch.as_tensor(np.arange(m) % n, device=device)
            self.pair_pose = torch.as_tensor(r.integers(0, len(self.poses), m), device=device)
            self.pair_code = torch.as_tensor(r.integers(0, traffic["texture_codes"] or 1, m),
                                             device=device)
            self.pair_background = torch.as_tensor(r.integers(0, 2, m), device=device)
            parts: Dict[str, List[torch.Tensor]] = {}
            for i in range(0, m, chunk):
                sl = slice(i, min(i + chunk, m))
                codes = None if self.codes is None else self.codes[self.pair_code[sl]]
                out = render_targets(self.vox[self.pair_shape[sl]], self.poses[self.pair_pose[sl]],
                                     codes, self.pair_background[sl], cfg["new_size"],
                                     cfg["image_factor"])
                for k, v in out.items():
                    parts.setdefault(k, []).append(v)
            self.targets = {k: torch.cat(v) for k, v in parts.items()}

    # ---- training ----
    def row_table(self, steps: int, batch: int) -> torch.Tensor:
        """``[steps, batch]``: each step's rows, ``batch`` different pairs, on
        the device (a step reads its row there, so feeding waits for
        nothing)."""
        r = _rng(self.seed, 4)
        m = self.traffic["pairs"]
        rows = np.stack([r.permutation(m)[:batch] for _ in range(steps)])
        return torch.as_tensor(rows, device=self.device)

    def train_batch(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"voxels": self.vox[self.pair_shape[rows]],
               "poses": self.poses[self.pair_pose[rows]]}
        for k, v in self.targets.items():
            out[k] = v[rows]
        if self.codes is not None:
            out["codes"] = self.codes[self.pair_code[rows]]
        return out

    # ---- rendering ----
    def request_table(self, n: int, views: int) -> Dict[str, torch.Tensor]:
        """The first ``n`` requests: a shape, ``views`` different poses and a
        code each."""
        r = _rng(self.seed, 3)
        shape = r.integers(0, len(self.vox), n)
        poses = np.argsort(r.random((n, len(self.poses))), axis=1)[:, :views]
        table = {"shape": torch.as_tensor(shape, device=self.device),
                 "poses": torch.as_tensor(poses, device=self.device)}
        if self.codes is not None:
            table["code"] = torch.as_tensor(r.integers(0, len(self.codes), n), device=self.device)
        return table
