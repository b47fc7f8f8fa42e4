"""Texture/normal face workload (PyTorch): texture decoder + two-head
RenderNet.

Counterpart of ``rendernet_tpu/models/texture_face.py``, which follows
RenderNet_Texture_Face_Normal.py of the reference:

  * the texture decoder (``texture_decoder``, :77-117): a 199-d texture
    code -> FC + PReLU -> ``[B, g, g, g, 4]`` -> a k4 s1 deconv -> stride-2
    k4 deconvs (scopes ``e_tex_conv1``, ``e_tex_conv1_2``, ...) until
    ``tex_grid`` -> a k4 conv to 4 channels, PReLU after each: a
    ``tex_grid^3 x 4`` texture grid (64^3 at the defaults);
  * :class:`TextureFaceRenderNet` (``texture_face_rendernet``, :145-226):
    the shader trunk at ``enc_channels`` (16 wide by default) up to
    ``res3_skip``, then two heads, "Image" (albedo) and "Normal", each
    conv(4 base) -> three stride-2 deconvs -> a deconv to 3 channels and a
    sigmoid in float32. The heads keep the reference's scope quirks for key
    parity: the inner scope of ``e_conv7`` is ``e_conv7_2`` in both heads,
    and the Image head's later deconvs sit under ``conv2d_transpose``
    (:130-142).

:func:`texture_face_forward` warps the shape grid and the decoded texture
grid independently and concatenates them on the channel axis (:240-263).
Under spatial sharding (``train.distributed.spatial_sharding``) each rank
of the model axis warps and renders its own rows, as the shader does
(``models/shader.py``): the decoder runs whole on every rank, the warps
emit the rank's camera rows plus e_conv1's halo, every conv and deconv of
the trunk and both heads exchanges the rows it reads, and each head's
output is the rank's image rows.
The convs route as the shader's (``nn/layers.py``): e_conv1 and e_conv2 on
the plain conv, e_conv3 / res1 / res1_skip on K2 (16 -> 16 channels), the
res2 (512 wide) and res3 (256 wide) stacks on K3 with ``WINOGRAD_2D`` (K5
with ``CUDA_CONV2D``); the 3-D deconvs of the decoder and the heads' convs
have no kernel in either package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from rendernet_tpu_torch import resolve_device
from rendernet_tpu_torch.nn.layers import (
    Conv,
    ConvTranspose,
    ConvUnit,
    FullyConnected,
    ProjectionUnit,
    ResBlock,
    dropout,
    res_block_stack,
)
from rendernet_tpu_torch.models.shader import camera_warp
from rendernet_tpu_torch.ops.halo import RowShard
from rendernet_tpu_torch.utils.spans import span

__all__ = [
    "TextureFaceConfig",
    "TextureFaceRenderNet",
    "texture_decoder",
    "texture_face_forward",
    "init_texture_face_params",
]


@dataclasses.dataclass(frozen=True)
class TextureFaceConfig:
    """Static hyperparameters, with the JAX config's fields and defaults
    (the reference network). ``tex_base``: the FC emits ``tex_base^3 x 4``
    and stride-2 deconvs double it to ``tex_grid``; a smaller base only
    shrinks the FC (the committed tiny nets use 8). ``remat``,
    ``preact_policy`` and ``scan_blocks`` are the shader's
    (:class:`~rendernet_tpu_torch.models.shader.ShaderConfig`); ``remat``
    here covers the 3D stack too, as in JAX."""

    texture_dim: int = 199
    tex_base: int = 32
    tex_grid: int = 64
    keep_prob: float = 1.0
    enc_channels: Tuple[int, int, int] = (8, 16, 16)
    res1_blocks: int = 10
    res2_blocks: int = 10
    res3_blocks: int = 5
    base: int = 32
    new_size: int = 128
    remat: bool = False
    preact_policy: bool = False
    scan_blocks: bool = False


_TRAIN_FIELDS = ("keep_prob", "remat", "preact_policy", "scan_blocks")


def _doublings(tex_base: int, tex_grid: int) -> int:
    g = tex_base
    if tex_grid % g or (tex_grid // g) & (tex_grid // g - 1):
        raise ValueError(f"tex_grid {tex_grid} must be tex_base {g} * 2^k")
    d = (tex_grid // g).bit_length() - 1
    if d < 1:
        raise ValueError("tex_grid must be at least 2*tex_base")
    return d


def _decoder_scope(cfg: TextureFaceConfig, generator: torch.Generator) -> nn.ModuleDict:
    """The texture decoder's modules, scoped as ``texture_encoder/...``."""
    g, k3, s1 = cfg.tex_base, (4, 4, 4), (1, 1, 1)
    enc = nn.ModuleDict()
    enc["e_tex_fc1"] = ConvUnit("fully_connected",
                                FullyConnected(cfg.texture_dim, g ** 3 * 4, generator), g ** 3 * 4)
    enc["e_tex_conv0"] = ConvUnit("conv3d_transpose", ConvTranspose(4, 4, k3, s1, generator), 4)
    for d in range(_doublings(g, cfg.tex_grid)):
        name = "e_tex_conv1" if d == 0 else f"e_tex_conv1_{d + 1}"
        enc[name] = ConvUnit("conv3d_transpose",
                             ConvTranspose(4 if d == 0 else 8, 8, k3, (2, 2, 2), generator), 8)
    enc["e_tex_conv2"] = ConvUnit("conv3d", Conv(8, 4, k3, s1, generator), 4)
    return enc


class TextureFaceRenderNet(nn.Module):
    """The texture decoder (``texture_encoder``, run by
    :func:`texture_decoder`) and the two-head renderer (``encoder``) of one
    parameter set, as JAX keeps them in one dict. :meth:`forward` runs the
    renderer on a camera-aligned grid ``[B, H, W, D, 5]`` -> (albedo,
    normal), each ``[B, 4H, 4W, 3]`` float32 in [0, 1]. Parameters stay
    float32."""

    def __init__(self, cfg: TextureFaceConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        g = generator
        self.texture_encoder = _decoder_scope(cfg, g)
        c1, c2, c3 = cfg.enc_channels
        depth = -(-cfg.new_size // 2)  # e_conv1 halves depth, e_conv2 again
        nf = -(-depth // 2) * c3
        b = cfg.base
        s1 = (1, 1)
        enc = nn.ModuleDict()
        enc["e_conv1"] = ConvUnit("e_conv1", Conv(5, c1, (5, 5, 5), (2, 2, 2), g), c1)
        enc["e_conv2"] = ConvUnit("e_conv2", Conv(c1, c2, (3, 3, 3), (1, 1, 2), g), c2)
        enc["e_conv3"] = ConvUnit("e_conv3", Conv(c2, c3, (3, 3, 3), (1, 1, 1), g), c3)
        for i in range(1, cfg.res1_blocks + 1):
            enc[f"res1_{i}"] = ResBlock(c3, 3, g)
        enc["res1_skip"] = nn.ModuleDict({"con1_3X3": Conv(c3, c3, (3, 3, 3), (1, 1, 1), g)})
        enc["projection_unit"] = ProjectionUnit(nf, g)
        for i in range(1, cfg.res2_blocks + 1):
            enc[f"res2_{i}"] = ResBlock(nf, 2, g)
        enc["res2_skip"] = nn.ModuleDict({"con1_3X3": Conv(nf, nf, (3, 3), s1, g)})
        enc["e_conv5"] = ConvUnit("e_conv5", Conv(nf, b * 8, (4, 4), s1, g), b * 8)
        for i in range(1, cfg.res3_blocks + 1):
            enc[f"res3_{i}"] = ResBlock(b * 8, 2, g)
        enc["res3_skip"] = nn.ModuleDict({"con1_3X3": Conv(b * 8, b * 8, (3, 3), s1, g)})
        for head, sfx in (("Image", "_1"), ("Normal", "_2")):
            h = nn.ModuleDict()
            h[f"e_conv6{sfx}"] = ConvUnit(f"e_conv6{sfx}", Conv(b * 8, b * 4, (4, 4), s1, g),
                                          b * 4)
            # the reference's quirk: e_conv7's inner scope is e_conv7_2 in both heads
            h[f"e_conv7{sfx}"] = ConvUnit(
                "e_conv7_2", ConvTranspose(b * 4, b * 2, (4, 4), (2, 2), g), b * 2)
            for n, ci, co in ((8, b * 2, b), (9, b, 16)):
                inner = "conv2d_transpose" if sfx == "_1" else f"e_conv{n}{sfx}"
                h[f"e_conv{n}{sfx}"] = ConvUnit(inner, ConvTranspose(ci, co, (4, 4), (2, 2), g),
                                                co)
            inner = "conv2d_transpose" if sfx == "_1" else f"e_conv10{sfx}"
            h[f"e_conv10{sfx}"] = nn.ModuleDict({inner: ConvTranspose(16, 3, (4, 4), s1, g)})
            enc[head] = h
        self.encoder = enc

    def _stack(self, prefix: str, n: int, x: torch.Tensor, remat: bool, preact: bool,
               shard: RowShard | None) -> torch.Tensor:
        """A residual stack, its skip conv and the fp32 shortcut add."""
        shortcut = x
        x = res_block_stack([self.encoder[f"{prefix}_{i}"] for i in range(1, n + 1)], x,
                            remat=remat, preact=preact, shard=shard)
        x = self.encoder[f"{prefix}_skip"]["con1_3X3"](x, shard=shard)
        return (x.float() + shortcut.float()).to(shortcut.dtype)

    def _head(self, head: str, sfx: str, trunk: torch.Tensor, unit,
              shard: RowShard | None) -> torch.Tensor:
        h = self.encoder[head]
        x = trunk
        with span("heads"):
            for n in (6, 7, 8, 9):
                x = unit(h[f"e_conv{n}{sfx}"], x)
            last = next(iter(h[f"e_conv10{sfx}"].values()))
            return torch.sigmoid((last(x) if shard is None else last(x, shard=shard)).float())

    def forward(self, vox: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                cfg: TextureFaceConfig | None = None, shard: RowShard | None = None,
                extended: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train``, ``generator``, ``cfg``, ``shard`` and ``extended``: as
        :meth:`~rendernet_tpu_torch.models.shader.ShaderRenderNet.forward`
        (``cfg`` may change keep_prob, remat, preact_policy, scan_blocks).
        With ``shard`` both heads return the rank's image rows, and the
        dropout masks of the trunk and of both heads are the rows of the
        whole run's masks."""
        e = self.encoder
        if cfg is None:
            cfg = self.cfg
        elif dataclasses.replace(cfg, **{f: getattr(self.cfg, f) for f in _TRAIN_FIELDS}) \
                != self.cfg:
            raise ValueError(f"cfg {cfg} does not describe this network ({self.cfg})")

        def unit(mod, x, **kw):
            y = mod(x) if shard is None else mod(x, shard=shard, **kw)
            return dropout(y, cfg.keep_prob, generator, train, shard=shard)

        pre = cfg.preact_policy
        with span("encoder3d"):
            x = unit(e["e_conv1"], vox, **({"extended": True} if extended else {}))
            for name in ("e_conv2", "e_conv3"):
                x = unit(e[name], x)
            x = self._stack("res1", cfg.res1_blocks, x, cfg.remat, pre, shard)
        with span("projection"):
            x = e["projection_unit"](x)  # a 1x1 conv over (depth, channel): local in the rows
        with span("stack2d"):
            x = self._stack("res2", cfg.res2_blocks, x, cfg.remat, pre, shard)
            x = unit(e["e_conv5"], x)
            trunk = self._stack("res3", cfg.res3_blocks, x, cfg.remat, pre, shard)
        return (self._head("Image", "_1", trunk, unit, shard),
                self._head("Normal", "_2", trunk, unit, shard))


def texture_decoder(net: TextureFaceRenderNet, z: torch.Tensor) -> torch.Tensor:
    """Texture code ``[B, texture_dim]`` -> ``[B, G, G, G, 4]`` (G =
    ``tex_grid``) by ``net``'s decoder, in ``z``'s dtype: FC + PReLU,
    reshape to ``tex_base^3 x 4``, the deconvs and the last conv, PReLU
    after each."""
    g = net.cfg.tex_base
    e = net.texture_encoder
    with span("decoder"):
        x = e["e_tex_fc1"](z).reshape(z.shape[0], g, g, g, 4)
        for name in list(e)[1:]:
            x = e[name](x)
        return x


def texture_face_forward(
    net: TextureFaceRenderNet,
    voxels: torch.Tensor,
    texture_code: torch.Tensor,
    view_params: torch.Tensor,
    *,
    train: bool = False,
    dropout_generator: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
    resample: str = "exact",
    mesh=None,
    gather: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode the texture grid, warp the shape grid and the texture grid
    (cast to float32) independently, concatenate them on the channel axis
    and run the two-head network: (albedo, normal). Gradients reach the
    decoder through the texture grid's warp (K4's voxel cotangent on the
    multipass path); the shape grid and the pose are data.

    ``mesh`` (``train.distributed.make_mesh``) with a model axis above 1:
    ``voxels`` is this rank's rows (axis 1) of the raw grid, which the
    ranks all-gather (a rotation mixes every axis); every rank decodes the
    whole texture grid, warps both grids to its slab of the camera rows
    with e_conv1's halo and returns its slab of each head's image rows, or
    with ``gather`` the whole images (every rank)."""
    from rendernet_tpu_torch.train.distributed import spatial_sharding

    cfg = net.cfg
    with span("render"):
        shard = None
        if mesh is not None and mesh.shape["model"] > 1:
            shard = spatial_sharding(mesh, 5)
            voxels = shard.gather(voxels)
        tex = texture_decoder(net, texture_code.to(compute_dtype))
        shape_cam = camera_warp(voxels.to(torch.float32), view_params, cfg.new_size, resample,
                                compute_dtype, shard)
        tex_cam = camera_warp(tex.to(torch.float32), view_params, cfg.new_size, resample,
                              compute_dtype, shard)
        both = torch.cat([shape_cam.to(compute_dtype), tex_cam.to(compute_dtype)], dim=4)
        albedo, normal = net(both, train=train, generator=dropout_generator, shard=shard,
                             extended=shard is not None)
        if gather and shard is not None:
            return shard.gather(albedo), shard.gather(normal)
        return albedo, normal


def init_texture_face_params(seed, cfg: TextureFaceConfig, device=None) -> TextureFaceRenderNet:
    """A freshly initialised network on ``device`` (CUDA unless the caller
    asks for the CPU). ``seed`` is an int or a CPU ``torch.Generator``."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    return TextureFaceRenderNet(cfg, gen).to(dev).eval()
