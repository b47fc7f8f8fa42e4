"""Synthetic dataset generation (no external data needed).

Counterpart of ``rendernet_tpu/data/synthetic.py``: datasets shaped like
the reference's training data (ShapeNet renders, Basel faces), made from
any ``.binvox`` assets with the port's own renderer as the ground truth:
the silhouette (max-projection) of the exact trilinear warp to a 128^3
camera grid, on the device the caller names (CUDA unless the caller asks
for the CPU), nearest-upsampled to ``img_res`` and encoded with the port's
``encode_png``.
"""
from __future__ import annotations

import io
import os
import tarfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rendernet_tpu_torch import resolve_device
from rendernet_tpu_torch.data.pose import pose_from_name, pose_to_name_suffix
from rendernet_tpu_torch.io import binvox as binvox_rw
from rendernet_tpu_torch.ops.resample import rotate_resample_to_camera
from rendernet_tpu_torch.ops.transforms import silhouette
from rendernet_tpu_torch.utils.image import encode_png, to_uint8

__all__ = ["make_synthetic_shader_tar", "synthetic_face_dataset", "beta_to_rgb"]


@torch.no_grad()
def _camera_grid(vox: np.ndarray, pose: np.ndarray, device: torch.device) -> np.ndarray:
    """The 128^3 camera-aligned grid ``[128, 128, 128]`` of one voxel grid."""
    v = torch.from_numpy(np.asarray(vox, np.float32)[None, :, :, :, None]).to(device)
    p = torch.from_numpy(np.asarray(pose, np.float32)[None]).to(device)
    return rotate_resample_to_camera(v, p, new_size=128)


def _upsample(img: np.ndarray, img_res: int) -> np.ndarray:
    factor = img_res // img.shape[0]
    if factor > 1:
        img = np.repeat(np.repeat(img, factor, axis=0), factor, axis=1)
    return img


def _render_silhouette(vox: np.ndarray, pose: np.ndarray, img_res: int,
                       device: torch.device) -> np.ndarray:
    """A [0, 255] greyscale silhouette target."""
    sil = silhouette(_camera_grid(vox, pose, device))[0, :, :, 0].cpu().numpy()
    return np.clip(_upsample(sil, img_res), 0.0, 1.0) * 255.0


def _render_sil_normal(vox: np.ndarray, pose: np.ndarray, img_res: int,
                       device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Silhouette in [0, 1] and a screen-space normal map from the camera
    grid's depth front (first occupied slice), encoded (n + 1) / 2, the
    background flat +Z (0.5, 0.5, 1), as the JAX package's
    (``synthetic.py:82-128``)."""
    occ = _camera_grid(vox, pose, device)[0, :, :, :, 0].cpu().numpy() > 0.5  # [H, W, D]
    sil = occ.any(axis=2).astype(np.float32)
    depth = np.where(sil > 0, np.argmax(occ, axis=2), occ.shape[2]).astype(np.float32)
    dy, dx = np.gradient(depth)
    n = np.stack([-dx, -dy, np.ones_like(dx) * 2.0], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal = (n + 1.0) * 0.5
    normal[sil == 0] = (0.5, 0.5, 1.0)
    return _upsample(sil, img_res), _upsample(normal, img_res)


def beta_to_rgb(beta: np.ndarray) -> np.ndarray:
    """An identity's colour from its first 3 texture-code dims: 0.3 + 0.65 *
    sigmoid(beta[:3]); the albedo head gets it right only by decoding the
    texture code."""
    b3 = np.asarray(beta).reshape(-1)[:3]
    return (0.3 + 0.65 / (1.0 + np.exp(-b3))).astype(np.float32)


def _read_binvox(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return binvox_rw.read_as_3d_array(f).data.astype(np.float32)


def _add_png(tf: tarfile.TarFile, name: str, png: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(png)
    tf.addfile(info, io.BytesIO(png))


def make_synthetic_shader_tar(
    out_dir: str,
    binvox_paths: Sequence[str],
    poses_deg: Sequence[Tuple[float, float]] = ((30, 60), (120, 75), (250, 100)),
    img_res: int = 512,
    radius: float = 3.3,
    device: Optional[str] = None,
) -> Tuple[str, str]:
    """Build (images.tar, model_dir) shaped like the reference training
    data: each asset becomes ``models/model_normalized_{i}_clean.binvox``
    and, per pose, a tar entry
    ``model_normalized_{i}_clean_p{az}_t{th}_r3.3.png`` (the pairing
    ``data_loader`` expects)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    model_dir = os.path.join(out_dir, "models")
    os.makedirs(model_dir, exist_ok=True)
    tar_path = os.path.join(out_dir, "images.tar")
    with tarfile.open(tar_path, "w") as tf:
        for i, bv_path in enumerate(binvox_paths):
            vox = _read_binvox(bv_path)
            model_name = f"model_normalized_{i}_clean"
            binvox_rw.save_binvox(vox > 0.5, os.path.join(model_dir, model_name + ".binvox"))
            for az, th in poses_deg:
                entry = model_name + pose_to_name_suffix(az, th, radius)
                img = _render_silhouette(vox, pose_from_name(entry), img_res, dev)
                _add_png(tf, entry + ".png", encode_png(to_uint8(img)))
    return tar_path, model_dir


def synthetic_face_dataset(
    out_dir: str,
    binvox_paths: Sequence[str],
    poses_deg: Sequence[Tuple[float, float]] = ((30, 60), (250, 100)),
    img_res: int = 512,
    texture_dim: int = 199,
    seed: int = 0,
    device: Optional[str] = None,
) -> Tuple[str, str, str, str]:
    """Build (images.tar, model_dir, texture_dir, normal_dir) shaped like the
    face workload's data: per identity ``ply{id}.binvox`` and
    ``beta{id}.mat`` (numpy's ``default_rng(seed)`` draws, as JAX's), per
    view an albedo tar entry (the silhouette times the identity's colour)
    and a normal-map PNG."""
    import scipy.io

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    model_dir = os.path.join(out_dir, "models")
    texture_dir = os.path.join(out_dir, "textures")
    normal_dir = os.path.join(out_dir, "normals")
    for d in (model_dir, texture_dir, normal_dir):
        os.makedirs(d, exist_ok=True)
    tar_path = os.path.join(out_dir, "images.tar")
    with tarfile.open(tar_path, "w") as tf:
        for i, bv_path in enumerate(binvox_paths):
            ident = f"ply{80000 + i}"
            vox = _read_binvox(bv_path)
            binvox_rw.save_binvox(vox > 0.5, os.path.join(model_dir, ident + ".binvox"))
            beta = rng.standard_normal((texture_dim, 1)).astype(np.float32)
            scipy.io.savemat(os.path.join(texture_dir, f"beta{ident.split('ly')[1]}.mat"),
                             {"beta": beta})
            rgb = beta_to_rgb(beta)
            for az, th in poses_deg:
                entry = ident + pose_to_name_suffix(az, th)
                sil, normal = _render_sil_normal(vox, pose_from_name(entry), img_res, dev)
                _add_png(tf, entry + ".png",
                         encode_png(to_uint8(sil[..., None] * rgb[None, None, :] * 255.0)))
                with open(os.path.join(normal_dir, entry + ".png"), "wb") as f:
                    f.write(encode_png(to_uint8(normal * 255.0)))
    return tar_path, model_dir, texture_dir, normal_dir
