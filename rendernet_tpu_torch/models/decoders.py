"""The inverse renderer's three networks (PyTorch): the shape decoder, the
texture decoder and the two-head renderer.

Counterpart of ``rendernet_tpu/models/decoders.py``, which follows
Reconstruct_RenderNet_Face.py of the reference:

  * :class:`ShapeDecoder3D` (:31-75): z ``[B, z_dim]`` -> FC -> ``[B, 4, 4,
    4, 256]`` -> four k4 s2 deconvs (128/64/32/16) with ELU -> a k4 s1
    deconv to one channel + sigmoid: a 64^3 occupancy grid;
  * :class:`ReconTextureDecoder` (:77-111): a 199-d code -> ``[B, 64, 64,
    64, 4]``, under the released weights' scope names (``e_tex_dc1/g_gc1``,
    inner deconvs named ``conv2d_transpose``);
  * :class:`ReconRenderNet` (:113-302): the 16-channel renderer whose
    projection is a raw channels-last reshape ``[B, H, W, D, C] -> [B, H,
    W, D*C]`` (channel ``d*C + c``) and a 1x1 ``e_conv4`` conv, with ``relu``
    res blocks and two heads (albedo, normal); the normal head's last deconv
    sits under ``e_conv11`` and not ``e_conv11_2`` (:182-187, a quirk of the
    released weights).

Child names mirror the TF scopes, so ``compat/jax_params.py`` carries the
JAX parameter dicts over strictly. Each network runs in the dtype of its
input (parameters stay float32 and are cast at each use); the sigmoid
outputs are float32. In inverse rendering the parameters are frozen.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rendernet_tpu_torch import resolve_device
from rendernet_tpu_torch.nn.layers import (
    Conv,
    ConvTranspose,
    ConvUnit,
    FullyConnected,
    ResBlock,
    res_block_stack,
)

__all__ = [
    "ShapeDecoder3D",
    "ReconTextureDecoder",
    "ReconRenderNet",
    "init_shape_decoder_params",
    "init_recon_texture_decoder_params",
    "init_recon_rendernet_params",
]


def _scoped(name: str, module: nn.Module) -> nn.ModuleDict:
    """A scope holding one module under the scope's own name
    (``g_conv1/g_conv1/weights``)."""
    return nn.ModuleDict({name: module})


class ShapeDecoder3D(nn.Module):
    """Latent z ``[B, z_dim]`` -> voxel occupancy ``[B, 64, 64, 64, 1]``."""

    def __init__(self, generator: torch.Generator, z_dim: int = 200):
        super().__init__()
        g = generator
        self.g_zP = _scoped("g_gc1", FullyConnected(z_dim, 4 * 4 * 4 * 256, g))
        chans = [(256, 128, "g_conv1"), (128, 64, "g_conv2"), (64, 32, "g_conv3"),
                 (32, 16, "g_conv4")]
        for ci, co, name in chans:
            self.add_module(name, _scoped(name, ConvTranspose(ci, co, (4, 4, 4), (2, 2, 2), g)))
        self.names = [name for _, _, name in chans]
        # The last deconv sits at the top level (no doubled scope).
        self.g_conv5 = ConvTranspose(16, 1, (4, 4, 4), (1, 1, 1), g)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.g_zP["g_gc1"](z).reshape(z.shape[0], 4, 4, 4, 256)
        for name in self.names:
            x = F.elu(getattr(self, name)[name](x))
        return torch.sigmoid(self.g_conv5(x).float())


class ReconTextureDecoder(nn.Module):
    """199-d texture code -> ``[B, 64, 64, 64, 4]``, released-weights naming.
    The FC emits 32*32*32*4 values (the reference's 4*4*4*512 literal is
    dead: the pretrained array fixes the shape)."""

    def __init__(self, generator: torch.Generator, texture_dim: int = 199):
        super().__init__()
        g = generator
        enc = nn.ModuleDict()
        enc["e_tex_dc1"] = ConvUnit("g_gc1", FullyConnected(texture_dim, 32 ** 3 * 4, g),
                                    32 ** 3 * 4)
        enc["e_tex_conv0"] = ConvUnit(
            "conv2d_transpose", ConvTranspose(4, 4, (4, 4, 4), (1, 1, 1), g), 4)
        enc["e_tex_conv1"] = ConvUnit(
            "conv2d_transpose", ConvTranspose(4, 8, (4, 4, 4), (2, 2, 2), g), 8)
        enc["e_tex_conv2"] = ConvUnit("conv3d", Conv(8, 4, (4, 4, 4), (1, 1, 1), g), 4)
        self.texture_encoder = enc

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        e = self.texture_encoder
        x = e["e_tex_dc1"](z).reshape(z.shape[0], 32, 32, 32, 4)
        for name in ("e_tex_conv0", "e_tex_conv1", "e_tex_conv2"):
            x = e[name](x)
        return x


class ReconRenderNet(nn.Module):
    """Camera grid ``[B, H, W, D, 5]`` (occupancy + 4 texture channels) ->
    (albedo, normal), each ``[B, 4H, 4W, 3]`` float32 in [0, 1]."""

    def __init__(self, generator: torch.Generator, new_size: int = 128, in_channels: int = 5):
        super().__init__()
        g = generator
        nf = -(-(-(-new_size // 2)) // 2) * 16  # e_conv1 halves depth, e_conv2 again
        s1 = (1, 1)
        enc = nn.ModuleDict()
        enc["e_conv1"] = ConvUnit("e_conv1", Conv(in_channels, 8, (5, 5, 5), (2, 2, 2), g), 8)
        enc["e_conv2"] = ConvUnit("e_conv2", Conv(8, 16, (3, 3, 3), (1, 1, 2), g), 16)
        enc["e_conv3"] = ConvUnit("e_conv3", Conv(16, 16, (3, 3, 3), (1, 1, 1), g), 16)
        for i in range(1, 11):
            enc[f"res1_{i}"] = ResBlock(16, 3, g, activation="relu")
        enc["res1_skip"] = _scoped("con1_3X3", Conv(16, 16, (3, 3, 3), (1, 1, 1), g))
        enc["e_conv4"] = ConvUnit("e_conv4", Conv(nf, nf, s1, s1, g), nf)
        for i in range(1, 11):
            enc[f"res2_{i}"] = ResBlock(nf, 2, g, activation="relu")
        enc["res2_skip"] = _scoped("con1_3X3", Conv(nf, nf, (3, 3), s1, g))
        enc["e_conv5"] = ConvUnit("e_conv5", Conv(nf, 256, (4, 4), s1, g), 256)
        for i in range(1, 6):
            enc[f"res3_{i}"] = ResBlock(256, 2, g, activation="relu")
        enc["res3_skip"] = _scoped("con1_3X3", Conv(256, 256, (3, 3), s1, g))
        for head, sfx in (("Image", "_1"), ("Normal", "_2")):
            h = nn.ModuleDict()
            h[f"e_conv6{sfx}"] = ConvUnit(f"e_conv6{sfx}", Conv(256, 128, (4, 4), s1, g), 128)
            for n, ci, co in ((7, 128, 64), (8, 64, 32), (9, 32, 16)):
                h[f"e_conv{n}{sfx}"] = ConvUnit(
                    f"e_conv{n}{sfx}", ConvTranspose(ci, co, (4, 4), (2, 2), g), co)
            outer = f"e_conv11{sfx}" if sfx == "_1" else "e_conv11"
            h[outer] = _scoped(f"e_conv11{sfx}", ConvTranspose(16, 3, (4, 4), s1, g))
            enc[head] = h
        self.encoder = enc

    def _stack(self, prefix: str, n: int, x: torch.Tensor) -> torch.Tensor:
        """A relu res stack, its skip conv and the fp32 shortcut add."""
        e = self.encoder
        y = res_block_stack([e[f"{prefix}_{i}"] for i in range(1, n + 1)], x)
        y = e[f"{prefix}_skip"]["con1_3X3"](y)
        return (y.float() + x.float()).to(x.dtype)

    def _head(self, head: str, sfx: str, trunk: torch.Tensor) -> torch.Tensor:
        h = self.encoder[head]
        y = trunk
        for n in (6, 7, 8, 9):
            y = h[f"e_conv{n}{sfx}"](y)
        outer = f"e_conv11{sfx}" if sfx == "_1" else "e_conv11"
        return torch.sigmoid(h[outer][f"e_conv11{sfx}"](y).float())

    def forward(self, vox: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        e = self.encoder
        x = e["e_conv3"](e["e_conv2"](e["e_conv1"](vox)))
        x = self._stack("res1", 10, x)
        b, h, w, d, c = x.shape
        x = e["e_conv4"](x.reshape(b, h, w, d * c))  # raw depth collapse, channel d*C + c
        x = self._stack("res2", 10, x)
        x = e["e_conv5"](x)
        trunk = self._stack("res3", 5, x)
        return self._head("Image", "_1", trunk), self._head("Normal", "_2", trunk)


def _generator(seed) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))


def init_shape_decoder_params(seed, z_dim: int = 200, device=None) -> ShapeDecoder3D:
    """A freshly initialised shape decoder on ``device`` (CUDA unless the
    caller asks for the CPU); ``seed`` is an int or a CPU
    ``torch.Generator``."""
    return ShapeDecoder3D(_generator(seed), z_dim).to(resolve_device(device)).eval()


def init_recon_texture_decoder_params(seed, texture_dim: int = 199,
                                      device=None) -> ReconTextureDecoder:
    """A freshly initialised texture decoder; see
    :func:`init_shape_decoder_params`."""
    return ReconTextureDecoder(_generator(seed), texture_dim).to(resolve_device(device)).eval()


def init_recon_rendernet_params(seed, new_size: int = 128, in_channels: int = 5,
                                device=None) -> ReconRenderNet:
    """A freshly initialised renderer for a ``new_size`` camera grid; see
    :func:`init_shape_decoder_params`."""
    return ReconRenderNet(_generator(seed), new_size, in_channels).to(
        resolve_device(device)).eval()
