"""The small host-side functions of the port against JAX's, on the CPU.

``ops/transforms.image_to_voxel_axes``, the crops of ``ops/crops.py``,
``ops/phong.np_generate_random_light_pos``, the binvox codec's sparse and
axis-order forms (``io/binvox.py``) and the reference weight-directory
writer (``compat/tf_import.py``), each on the same seeded numpy inputs as
the JAX function it mirrors. All exact (copies, slices and numpy), so the
comparisons are equalities, except the light positions (float64 trig in
both: equal too). The random crops draw their offsets from another stream
in each package, so they are checked for synchrony and range, and at given
offsets against JAX's crop.
"""
from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.compat import tf_import as jtf
from rendernet_tpu.io import binvox as jbv
from rendernet_tpu.ops import crops as jcrops
from rendernet_tpu.ops import phong as jphong
from rendernet_tpu.ops import transforms as jtr
from rendernet_tpu_torch.compat import tf_import as ttf
from rendernet_tpu_torch.io import binvox as tbv
from rendernet_tpu_torch.ops import crops as tcrops
from rendernet_tpu_torch.ops import phong as tphong
from rendernet_tpu_torch.ops import transforms as ttr


def test_image_to_voxel_axes_matches_jax_and_inverts():
    x = np.random.default_rng(0).standard_normal((2, 5, 6, 4, 3)).astype(np.float32)
    got = ttr.image_to_voxel_axes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtr.image_to_voxel_axes(jnp.asarray(x))))
    back = ttr.voxel_to_image_axes(ttr.image_to_voxel_axes(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(back, x)


def _crop_inputs(rng, vdim=16, factor=4):
    vox = rng.random((2, vdim, vdim, vdim, 1)).astype(np.float32)
    tex = rng.random((2, vdim, vdim, vdim, 4)).astype(np.float32)
    img = rng.random((2, vdim * factor, vdim * factor, 3)).astype(np.float32)
    nrm = rng.random((2, vdim * factor, vdim * factor, 3)).astype(np.float32)
    return vox, tex, img, nrm


@pytest.mark.parametrize("which", ["voxel_image", "voxel_texture_image",
                                   "voxel_texture_image_normal"])
@pytest.mark.parametrize("patch", [6, 16])
def test_random_crops_synchronized_in_range(which, patch):
    """Every output of one call is cut at the same (u, v) offsets in
    [0, dim - patch] (image offsets scaled by the image/voxel factor), as
    JAX's crop at those offsets; a full-size patch returns the inputs."""
    rng = np.random.default_rng(1)
    vox, tex, img, nrm = _crop_inputs(rng)
    args = {"voxel_image": (vox, img), "voxel_texture_image": (vox, tex, img),
            "voxel_texture_image_normal": (vox, tex, img, nrm)}[which]
    tfn = getattr(tcrops, f"random_crop_{which}")
    jfn = getattr(jcrops, f"random_crop_{which}")
    gen = torch.Generator().manual_seed(3)
    seen = set()
    for _ in range(6):
        outs = tfn(gen, *(torch.from_numpy(a) for a in args), patch)
        jouts = jfn(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args), patch)
        assert [o.shape for o in outs] == [tuple(o.shape) for o in jouts]
        if patch == 16:
            for o, a in zip(outs, args):
                np.testing.assert_array_equal(o.numpy(), a)
            return
        # recover the offsets from the first voxel crop, check every output
        hits = [(u, v) for u in range(16 - patch + 1) for v in range(16 - patch + 1)
                if np.array_equal(vox[:, u:u + patch, v:v + patch], outs[0].numpy())]
        assert len(hits) == 1
        (u, v), seen = hits[0], seen | set(hits)
        off = jnp.asarray([u, v])
        for o, a in zip(outs, args):
            if a.ndim == 5:
                want = jcrops.crop_voxel(jnp.asarray(a), off, patch)
            else:
                want = jcrops.crop_image(jnp.asarray(a), off, patch, 4)
            np.testing.assert_array_equal(o.numpy(), np.asarray(want))
    assert len(seen) > 1  # the offsets move from call to call


@pytest.mark.parametrize("patch", [4, 7, 16])
def test_center_crops_match_jax(patch):
    rng = np.random.default_rng(2)
    vox, _, img, _ = _crop_inputs(rng)
    np.testing.assert_array_equal(
        tcrops.center_crop_voxel(torch.from_numpy(vox), patch).numpy(),
        np.asarray(jcrops.center_crop_voxel(jnp.asarray(vox), patch)))
    np.testing.assert_array_equal(
        tcrops.center_crop_image(torch.from_numpy(img), patch).numpy(),
        np.asarray(jcrops.center_crop_image(jnp.asarray(img), patch)))
    for a, b in zip(tcrops.center_crop_voxel_image(torch.from_numpy(vox), torch.from_numpy(img),
                                                   patch),
                    jcrops.center_crop_voxel_image(jnp.asarray(vox), jnp.asarray(img), patch)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape", [(5, 9, 7), (8, 8, 8), (1, 4, 2)])
def test_center_pad_cube_matches_jax(shape):
    v = np.random.default_rng(3).random(shape) > 0.5
    got = tcrops.center_pad_cube(v)
    np.testing.assert_array_equal(got, jcrops.center_pad_cube(v))
    assert got.shape == (max(shape),) * 3


def test_random_light_pos_matches_jax():
    """Same numpy Generator state in, same positions out; unit vectors."""
    for kw in ({}, {"elevation_range": (30, 60), "azimuth_range": (90, 180)}):
        got = tphong.np_generate_random_light_pos(16, np.random.default_rng(4), **kw)
        want = jphong.np_generate_random_light_pos(16, np.random.default_rng(4), **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-12)


def _model(n=12, seed=5):
    d = np.random.default_rng(seed).random((n, n, n)) > 0.7
    return jbv.Voxels(d, [n] * 3, [0.5, -1.0, 2.0], 1.5, "xyz")


@pytest.mark.parametrize("fix_coords", [True, False])
def test_binvox_read_forms_match_jax(fix_coords):
    """read_as_3d_array / read_as_coord_array with and without fix_coords,
    loads: the same arrays, header fields and axis order as JAX's."""
    buf = io.BytesIO()
    _model().write(buf)
    raw = buf.getvalue()
    for name in ("read_as_3d_array", "read_as_coord_array"):
        got = getattr(tbv, name)(io.BytesIO(raw), fix_coords=fix_coords)
        want = getattr(jbv, name)(io.BytesIO(raw), fix_coords=fix_coords)
        np.testing.assert_array_equal(got.data, want.data)
        assert (got.dims, got.translate, got.scale, got.axis_order) == \
            (want.dims, want.translate, want.scale, want.axis_order)
    np.testing.assert_array_equal(tbv.loads(raw).data, jbv.loads(raw).data)


@pytest.mark.parametrize("order", ["xyz", "xzy"])
@pytest.mark.parametrize("sparse", [False, True])
def test_binvox_write_forms_byte_equal_to_jax(order, sparse):
    """write honours axis_order and densifies a sparse model: the port's
    bytes equal JAX's, and each package reads the other's back."""
    m = _model(seed=6)
    data = jbv.dense_to_sparse(m.data) if sparse else m.data
    jm = jbv.Voxels(data, m.dims, m.translate, m.scale, order)
    tm = tbv.Voxels(data, m.dims, m.translate, m.scale, order)
    jb, tb = io.BytesIO(), io.BytesIO()
    jm.write(jb)
    tm.clone().write(tb)
    assert tb.getvalue() == jb.getvalue()
    back = tbv.read_as_3d_array(io.BytesIO(jb.getvalue()), fix_coords=order == "xyz").data
    np.testing.assert_array_equal(back, m.data)


def test_dense_sparse_round_trip_matches_jax():
    rng = np.random.default_rng(7)
    d = rng.random((6, 7, 5)) > 0.6
    sp = tbv.dense_to_sparse(d)
    np.testing.assert_array_equal(sp, jbv.dense_to_sparse(d))
    np.testing.assert_array_equal(tbv.sparse_to_dense(sp, d.shape), d)
    wild = np.concatenate([sp, np.array([[-1, 9], [0, 0], [0, 99]])], axis=1)  # out of range
    for dims in (d.shape, 9):
        np.testing.assert_array_equal(tbv.sparse_to_dense(wild, dims),
                                      jbv.sparse_to_dense(wild, dims))
    with pytest.raises(ValueError):
        tbv.dense_to_sparse(d[0])
    with pytest.raises(ValueError):
        tbv.sparse_to_dense(sp[:2], 4)


def _params(seed=8):
    rng = np.random.default_rng(seed)
    return {"encoder/e_conv1/e_conv1/weights": rng.standard_normal((5, 5, 5, 1, 8)).astype(
                np.float32),
            "encoder/Image/e_conv6_1/alpha": rng.standard_normal(4).astype(np.float32),
            "texture_encoder/e_tex_fc1/fully_connected/biases": rng.standard_normal(3).astype(
                np.float32),
            "g_zP/g_gc1/weights": rng.standard_normal((6, 2)).astype(np.float32)}


def test_weight_dict_matches_jax():
    p = _params()
    got, want = ttf.weight_dict_from_params(p), jtf.weight_dict_from_params(p)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reference_weight_dir_round_trip_across_packages(tmp_path, writer):
    """One package writes a reference weight directory (all keys, then a
    subset), the other reads it back onto the same parameter paths."""
    p = _params()
    w_mod, r_mod = (jtf, ttf) if writer == "jax" else (ttf, jtf)
    w_mod.export_reference_weight_dir(p, str(tmp_path / "all"))
    back = r_mod.params_from_weight_dict(p, r_mod.load_reference_weight_dir(str(tmp_path / "all")))
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])
    keys = ["e_conv1_e_conv1_weights", "g_zP_g_gc1_weights"]
    w_mod.export_reference_weight_dir(p, str(tmp_path / "some"), keys=keys)
    assert sorted(r_mod.load_reference_weight_dir(str(tmp_path / "some"))) == sorted(keys)
