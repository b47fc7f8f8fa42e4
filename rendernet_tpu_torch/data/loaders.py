"""Chunked streaming data loaders (host-side generators, numpy).

Counterpart of ``rendernet_tpu/data/loaders.py`` (which follows
``tools/data_util.py``): ``model_loader`` (:52), ``data_loader`` (:82) and
``data_loader_image_texture_normal_face`` (:155). A chunk is
``batch_size * batches_chunk`` entries; greyscale flattens by channel mean;
poses are parsed from the entry names; each image pairs with its binvox by
name; a partial last chunk is padded by repetition to a batch multiple.
Images stay float32 in [0, 255] (the training loop feeds them to the card
as uint8). Binvox payloads decode natively where the codec builds
(``io.binvox.decode_bytes``), PNGs likewise (``utils.image.decode_image``);
the face loader reads the per-identity Basel beta from ``.mat`` files with
scipy.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from rendernet_tpu_torch.data.pose import pose_from_name
from rendernet_tpu_torch.io import binvox as binvox_rw
from rendernet_tpu_torch.io.tar_archive import NpyTarReader
from rendernet_tpu_torch.utils.image import decode_image

__all__ = ["model_loader", "data_loader", "data_loader_image_texture_normal_face"]


def _pad_tail(arrays, names, counter: int, batch_size: int):
    """Pad a partial final chunk by repetition up to one batch."""
    reps = int(np.ceil(float(batch_size) / counter))
    out = [np.repeat(a[:counter], reps, axis=0)[:batch_size] for a in arrays]
    names = list(np.repeat(names[:counter], reps, axis=0)[:batch_size])
    return out, names


def _binvox_for_image(img_name: str, model_path: str) -> str:
    """Image entry name -> paired binvox path (tools/data_util.py:121-131)."""
    content = img_name.split("_")
    if "ply" in content[0]:
        return os.path.join(model_path, content[0] + ".binvox")
    cand = os.path.join(model_path, f"model_chair_{content[2]}_clean.binvox")
    if os.path.exists(cand):
        return cand
    return os.path.join(model_path, f"model_normalized_{content[2]}_clean.binvox")


def _read_voxels(path: str, voxel_res: int) -> np.ndarray:
    with open(path, "rb") as f:
        return np.reshape(binvox_rw.decode_bytes(f.read()).astype(np.float32),
                          (voxel_res, voxel_res, voxel_res, 1))


def _entries(img_path: str, shard: Optional[Tuple[int, int]]):
    """(image, name) of every decodable entry of the tar, strided by
    ``shard=(index, count)``."""
    entry_idx = 0
    with NpyTarReader(img_path) as reader:
        for img, img_name in reader:
            if img is None or img_name is None:
                continue
            entry_idx += 1
            if shard is not None and (entry_idx - 1) % shard[1] != shard[0]:
                continue
            yield img, img_name


def model_loader(model_path: str, batch_size: int, batches_chunk: int = 1,
                 voxel_res: int = 64) -> Iterator[Tuple[np.ndarray, list]]:
    """Stream (voxel chunk, names) out of a binvox tar."""
    chunk = batch_size * batches_chunk
    mods = np.zeros((chunk, voxel_res, voxel_res, voxel_res, 1), np.float32)
    names: list = []
    counter = 0
    with NpyTarReader(model_path) as reader:
        for mod, name in reader:
            if mod is None:
                continue
            mods[counter % chunk] = np.reshape(mod.astype(np.float32),
                                               (voxel_res, voxel_res, voxel_res, 1))
            names.append(name)
            counter += 1
            if counter == chunk:
                yield mods, names
                counter = 0
                mods = np.zeros_like(mods)
                names = []
        if counter > 0:
            (mods,), names = _pad_tail([mods], names, counter, batch_size)
            yield mods, names


def data_loader(
    img_path: str,
    model_path: str,
    batch_size: int,
    batches_chunk: int = 1,
    validation_mode: bool = False,
    flatten: bool = False,
    img_res: int = 512,
    voxel_res: int = 64,
    add_noise: bool = False,
    rng: Optional[np.random.Generator] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, list]]:
    """Stream (images, voxels, poses, names) chunks for shader training.
    Images are float32 in [0, 255] (``flatten``: the channel mean, one
    channel); poses (azimuth, elevation, scale). ``shard=(index, count)``
    strides the entries, as for a multi-process input pipeline."""
    chunk = batch_size if validation_mode else batch_size * batches_chunk
    channels = 1 if flatten else 3
    ims = np.zeros((chunk, img_res, img_res, channels), np.float32)
    mods = np.zeros((chunk, voxel_res, voxel_res, voxel_res, 1), np.float32)
    params = np.zeros((chunk, 3), np.float32)
    names: list = []
    counter = 0
    if add_noise and rng is None:
        rng = np.random.default_rng()
    for img, img_name in _entries(img_path, shard):
        idx = counter % chunk
        img = np.asarray(img, np.float32)
        if flatten:
            img = img.mean(axis=2, keepdims=True) if img.ndim == 3 else img.reshape(
                img_res, img_res, 1)
        else:
            img = img[:, :, :3]
        ims[idx] = img.reshape(img_res, img_res, channels)
        if add_noise:
            ims[idx] += rng.uniform(0.0, 1.0, size=ims[idx].shape)
        params[idx] = pose_from_name(img_name)
        names.append(img_name)
        mods[idx] = _read_voxels(_binvox_for_image(img_name, model_path), voxel_res)
        counter += 1
        if counter == chunk:
            yield ims, mods, params, names
            counter = 0
            ims, mods, params = np.zeros_like(ims), np.zeros_like(mods), np.zeros_like(params)
            names = []
    if counter > 0:
        (ims, mods, params), names = _pad_tail([ims, mods, params], names, counter, batch_size)
        yield ims, mods, params, names


def data_loader_image_texture_normal_face(
    img_path: str,
    model_path: str,
    texture_path: str,
    normal_path: str,
    batch_size: int,
    batches_chunk: int = 1,
    validation_mode: bool = False,
    img_res: int = 512,
    voxel_res: int = 64,
    texture_dim: int = 199,
    add_noise: bool = False,
    rng: Optional[np.random.Generator] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Stream (images, normals, voxels, textures, poses, names) for the face
    workload: the per-identity beta from ``beta{id}.mat``, the normal map
    from ``{entry}.png`` (tools/data_util.py:182-187)."""
    import scipy.io

    chunk = batch_size if validation_mode else batch_size * batches_chunk
    ims = np.zeros((chunk, img_res, img_res, 3), np.float32)
    normals = np.zeros((chunk, img_res, img_res, 3), np.float32)
    mods = np.zeros((chunk, voxel_res, voxel_res, voxel_res, 1), np.float32)
    texs = np.zeros((chunk, texture_dim), np.float32)
    params = np.zeros((chunk, 3), np.float32)
    names: list = []
    counter = 0
    if add_noise and rng is None:
        rng = np.random.default_rng()
    for img, img_name in _entries(img_path, shard):
        idx = counter % chunk
        ims[idx] = np.asarray(img, np.float32)[:, :, :3]
        if add_noise:
            ims[idx] += rng.uniform(0.0, 1.0, size=ims[idx].shape)
        ident = img_name.split("_")[0]  # e.g. "ply80055"
        beta = scipy.io.loadmat(os.path.join(texture_path, f"beta{ident.split('ly')[1]}.mat"))
        texs[idx] = np.reshape(beta["beta"].astype(np.float32), texture_dim)
        with open(os.path.join(normal_path, img_name + ".png"), "rb") as f:
            normals[idx] = decode_image(f.read()).astype(np.float32)[:, :, :3]
        params[idx] = pose_from_name(img_name)
        names.append(img_name)
        mods[idx] = _read_voxels(os.path.join(model_path, ident + ".binvox"), voxel_res)
        counter += 1
        if counter == chunk:
            yield ims, normals, mods, texs, params, names
            counter = 0
            ims, normals, mods = np.zeros_like(ims), np.zeros_like(normals), np.zeros_like(mods)
            texs, params = np.zeros_like(texs), np.zeros_like(params)
            names = []
    if counter > 0:
        (ims, normals, mods, texs, params), names = _pad_tail(
            [ims, normals, mods, texs, params], names, counter, batch_size)
        yield ims, normals, mods, texs, params, names
