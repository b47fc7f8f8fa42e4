"""The port's host data pipeline against the JAX package on the CPU: the
loaders on datasets JAX builds, the synthetic datasets the port renders,
and the native codecs against the pure-Python ones.

Every dataset is made in ``tmp_path`` from a procedural voxel grid the test
writes; nothing outside the repository is read.
"""
from __future__ import annotations

import io
import os
import struct
import tarfile
import zlib

import numpy as np
import pytest
import scipy.io

from rendernet_tpu.data import loaders as jloaders
from rendernet_tpu.data import synthetic as jsynthetic
from rendernet_tpu.io import binvox as jbinvox
from rendernet_tpu_torch.data import loaders as tloaders
from rendernet_tpu_torch.data import synthetic as tsynthetic
from rendernet_tpu_torch.io import binvox as tbinvox
from rendernet_tpu_torch.io import native, native_img
from rendernet_tpu_torch.io.tar_archive import NpyTarWriter
from rendernet_tpu_torch.utils import image as timage
from test_torch_recon_parts import _png_all_filters
from test_torch_texture import sphere_box

POSES = ((30, 60), (250, 100))


@pytest.fixture(scope="module")
def binvox_paths(tmp_path_factory):
    """Two procedural 64^3 models (a sphere and a box, and its mirror image)."""
    d = tmp_path_factory.mktemp("vox")
    grid = sphere_box(64)
    paths = []
    for i, g in enumerate((grid, grid[::-1])):
        paths.append(str(d / f"proc{i}.binvox"))
        tbinvox.save_binvox(np.ascontiguousarray(g), paths[-1])
    return paths


@pytest.fixture(scope="module")
def jax_shader_data(binvox_paths, tmp_path_factory):
    return jsynthetic.make_synthetic_shader_tar(
        str(tmp_path_factory.mktemp("jshader")), binvox_paths, POSES, img_res=128)


@pytest.fixture(scope="module")
def jax_face_data(binvox_paths, tmp_path_factory):
    return jsynthetic.synthetic_face_dataset(
        str(tmp_path_factory.mktemp("jface")), binvox_paths, POSES, img_res=128)


def _assert_chunks_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert list(a) == list(b)


@pytest.mark.parametrize("flatten,batch,chunk", [(True, 3, 1), (False, 2, 2)])
def test_shader_loader_matches_jax(jax_shader_data, jax_face_data, flatten, batch, chunk):
    """data_loader: the same chunks (images, voxels, poses) bit for bit and
    the same names, greyscale on JAX's synthetic shader tar with a padded
    tail (4 entries in batches of 3), RGB on its face tar (``ply`` entries
    pair with ``ply<id>.binvox``) with two batches a chunk, and sharded."""
    tar, mdir = jax_shader_data if flatten else jax_face_data[:2]
    kw = dict(batch_size=batch, batches_chunk=chunk, flatten=flatten, img_res=128)
    _assert_chunks_equal(tloaders.data_loader(tar, mdir, **kw),
                         jloaders.data_loader(tar, mdir, **kw))
    kw = dict(batch_size=1, flatten=flatten, img_res=128, shard=(1, 2))
    _assert_chunks_equal(tloaders.data_loader(tar, mdir, **kw),
                         jloaders.data_loader(tar, mdir, **kw))


def test_face_loader_matches_jax(jax_face_data):
    """data_loader_image_texture_normal_face on JAX's synthetic face
    dataset: images, normals, voxels, betas, poses and names bit for bit,
    in validation mode too."""
    tar, mdir, tdir, ndir = jax_face_data
    for kw in (dict(batch_size=3), dict(batch_size=2, validation_mode=True)):
        _assert_chunks_equal(
            tloaders.data_loader_image_texture_normal_face(tar, mdir, tdir, ndir, img_res=128,
                                                           **kw),
            jloaders.data_loader_image_texture_normal_face(tar, mdir, tdir, ndir, img_res=128,
                                                           **kw))


def test_model_loader_matches_jax(binvox_paths, tmp_path):
    """model_loader on a tar of binvox entries, 3 models in batches of 2."""
    tar = str(tmp_path / "models.tar")
    with tarfile.open(tar, "w") as tf:
        for i, p in enumerate(binvox_paths + binvox_paths[:1]):
            tf.add(p, arcname=f"model_chair_{i}_x_clean.binvox")
    _assert_chunks_equal(tloaders.model_loader(tar, batch_size=2),
                         jloaders.model_loader(tar, batch_size=2))


def _tar_images(path):
    with tarfile.open(path) as tf:
        return {m.name: timage.decode_image(tf.extractfile(m).read()) for m in tf.getmembers()}


def test_synthetic_shader_tar_matches_jax(binvox_paths, jax_shader_data, tmp_path):
    """The port's make_synthetic_shader_tar (exact warp on the CPU, its own
    PNG encoder) against JAX's: the same entry names and models, and every
    pixel within 1 uint8 step (the two exact warps round differently at
    the silhouette's edge)."""
    tar, mdir = tsynthetic.make_synthetic_shader_tar(str(tmp_path), binvox_paths, POSES,
                                                     img_res=128, device="cpu")
    got, want = _tar_images(tar), _tar_images(jax_shader_data[0])
    assert sorted(got) == sorted(want) and len(got) == 4
    for k in want:
        assert got[k].shape == want[k].shape == (128, 128)
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k
        assert want[k].max() == 255 and want[k].min() == 0
    assert sorted(os.listdir(mdir)) == sorted(os.listdir(jax_shader_data[1]))
    for name in os.listdir(mdir):
        np.testing.assert_array_equal(tbinvox.load_binvox(os.path.join(mdir, name)),
                                      jbinvox.load_binvox(os.path.join(jax_shader_data[1], name)))


def test_synthetic_face_dataset_matches_jax(binvox_paths, jax_face_data, tmp_path):
    """synthetic_face_dataset: the same betas (numpy's default_rng(seed)) and
    file names; albedo pixels within 1 uint8 step; normal maps within 1
    step on all but the pixels where the depth front moves by a voxel
    between the two warps (at most 2% of them)."""
    got = tsynthetic.synthetic_face_dataset(str(tmp_path), binvox_paths, POSES, img_res=128,
                                            device="cpu")
    tar, mdir, tdir, ndir = got
    jtar, jmdir, jtdir, jndir = jax_face_data
    imgs, jimgs = _tar_images(tar), _tar_images(jtar)
    assert sorted(imgs) == sorted(jimgs) and len(imgs) == 4
    for k in jimgs:
        assert np.abs(imgs[k].astype(int) - jimgs[k].astype(int)).max() <= 1, k
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jtdir))
    for name in os.listdir(tdir):
        np.testing.assert_array_equal(scipy.io.loadmat(os.path.join(tdir, name))["beta"],
                                      scipy.io.loadmat(os.path.join(jtdir, name))["beta"])
    assert sorted(os.listdir(ndir)) == sorted(os.listdir(jndir))
    for name in os.listdir(ndir):
        with open(os.path.join(ndir, name), "rb") as f, open(os.path.join(jndir, name), "rb") as g:
            a, b = timage.decode_image(f.read()).astype(int), timage.decode_image(g.read())
        far = np.abs(a - b.astype(int)).max(axis=-1) > 1
        assert far.mean() <= 0.02, (name, far.mean())


def _pil_png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _filter_types(png: bytes):
    """The filter type of every row of an 8-bit non-interlaced PNG."""
    pos, idat, header = 8, [], None
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, _, color = header[:4]
    stride = 1 + w * {0: 1, 2: 3, 4: 2, 6: 4}[color]
    data = zlib.decompress(b"".join(idat))
    return {data[y * stride] for y in range(h)}


def _test_images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:96, :80]
    grad = np.stack([yy * 2 + xx, xx * 3, (yy * xx) % 256], -1) % 256
    noisy = np.clip(grad + rng.integers(-6, 7, grad.shape), 0, 255).astype(np.uint8)
    smooth = (127 + 120 * np.sin(yy / 9.0)[..., None] * np.cos(xx / 7.0)[..., None]
              * np.array([1.0, 0.6, -0.8])).astype(np.uint8)
    return {"rgb_noisy": noisy, "rgb_smooth": smooth,
            "grey": noisy[..., 0], "rgba": np.concatenate([smooth, noisy[..., :1]], -1),
            "random": rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)}


def test_native_png_decoder_matches_python():
    """The native decoder (native/imgio.cc, built into the port's _build)
    and the pure-Python one decode PIL's PNGs (grey, RGB, RGBA; PIL picks
    sub, up and Paeth rows here) and a PNG that uses every filter type row
    by row to the original pixels; decode_image takes the native one and
    counts it."""
    assert native_img.available(), native_img.error()
    seen = set()
    for name, img in _test_images().items():
        for png in (_pil_png(img), _png_all_filters(img)):
            seen |= _filter_types(png)
            got = native_img.decode_png(png)
            np.testing.assert_array_equal(got, img, err_msg=name)
            np.testing.assert_array_equal(timage.decode_png_python(png), img, err_msg=name)
    assert seen == {0, 1, 2, 3, 4}
    before = timage.decoded_by["native"]
    timage.decode_image(_pil_png(_test_images()["grey"]))
    assert timage.decoded_by["native"] == before + 1
    assert native_img.decode_png(b"GIF89a" + bytes(20)) is None


def test_native_binvox_codec_matches_numpy():
    """decode_bytes (native) equals the numpy reader on bytes of both
    writers, the JAX package's numpy decoder agrees, and the native encoder
    writes what the port's numpy writer writes."""
    assert native.available()
    rng = np.random.default_rng(1)
    for grid in (sphere_box(64), rng.random((10, 10, 10)) > 0.5, np.zeros((5, 5, 5), bool)):
        buf = io.BytesIO()
        tbinvox.write(tbinvox.Voxels(grid, list(grid.shape), [0.0, 0.0, 0.0], 1.0), buf)
        raw = buf.getvalue()
        want = tbinvox.read_as_3d_array(io.BytesIO(raw)).data
        np.testing.assert_array_equal(want, grid)
        np.testing.assert_array_equal(tbinvox.decode_bytes(raw), want)
        np.testing.assert_array_equal(native.decode(native.encode(grid)), grid)
        np.testing.assert_array_equal(jbinvox.read_as_3d_array(io.BytesIO(raw)).data, want)
    batch = native.decode_batch([native.encode(sphere_box(64))] * 2, (64, 64, 64))
    np.testing.assert_array_equal(batch, np.repeat(sphere_box(64)[None], 2, 0).astype(np.float32))


def test_tar_writer_and_reader_round_trip(tmp_path):
    """NpyTarWriter entries read back by the port's reader and by JAX's;
    binvox entries pair with their model names."""
    from rendernet_tpu.io.tar_archive import NpyTarReader as JReader
    from rendernet_tpu_torch.io.tar_archive import NpyTarReader, derive_model_name

    arrs = {f"a{i}": np.random.default_rng(i).random((3, i + 1)).astype(np.float32)
            for i in range(3)}
    path = str(tmp_path / "arr.tar")
    with NpyTarWriter(path) as w:
        for k, v in arrs.items():
            w.add(v, k)
    for reader in (NpyTarReader, JReader):
        got = {name: a for a, name in reader(path)}
        assert sorted(got) == sorted(arrs)
        for k in arrs:
            np.testing.assert_array_equal(got[k], arrs[k])
    assert derive_model_name("model_chair_7_x_p30_t60_r3.3") == "model_chair_7_clean"
    assert derive_model_name("ply80001_p30_t60_r3.3") == "ply80001"
