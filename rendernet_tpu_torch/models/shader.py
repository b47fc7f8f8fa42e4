"""RenderNet shader model (PyTorch): voxel grid -> image.

Counterpart of ``rendernet_tpu/models/shader.py`` (the network at :87-170,
``shader_forward`` at :173): a strided conv3d encoder (8/16/32 channels),
a 3D residual stack + skip conv, the learned projection unit, 2D residual
stacks at depth*32 and base*16 channels with skips, 4x4 convs, the deconv
chain and a sigmoid. Differentiable in its parameters; in train mode with
``keep_prob < 1`` every encoder unit's output goes through dropout.

Under spatial sharding (``train.distributed.spatial_sharding``) each rank
of the model axis renders its own rows: it warps its slab of the camera
grid's rows plus e_conv1's halo, every conv and deconv exchanges the rows
it reads with the neighbouring ranks (``nn/layers.py``), and its output is
its slab of the image rows.
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
    ProjectionUnit,
    ResBlock,
    conv_halo,
    dropout,
    res_block_stack,
)
from rendernet_tpu_torch.ops.cuda_resample import (
    rotate_resample_camera_patch_multipass,
    rotate_resample_to_camera_multipass,
)
from rendernet_tpu_torch.ops.halo import RowShard
from rendernet_tpu_torch.ops.resample import (
    rotate_resample_camera_patch,
    rotate_resample_to_camera,
)
from rendernet_tpu_torch.utils.spans import span

__all__ = ["ShaderConfig", "ShaderRenderNet", "shader_forward", "init_shader_params",
           "INPUT_HALO", "slab_rows", "camera_warp"]

# e_conv1's halo (5x5x5 stride 2): the camera-grid rows a rank's slab reads
# from its neighbours, which each rank warps itself.
INPUT_HALO = conv_halo(5, 2)


@dataclasses.dataclass(frozen=True)
class ShaderConfig:
    """Static hyperparameters; the defaults are the reference network for a
    128-deep camera grid with a greyscale head (``out_channels=3`` is the
    normal-map head of the render demo), with the JAX config's fields and
    defaults. The training fields:

    * ``keep_prob``: dropout keep probability of the encoder units in train
      mode (1.0: no dropout).
    * ``remat``: recompute every res block's forward in the backward pass
      (``torch.utils.checkpoint``) instead of keeping its activations.
    * ``remat_3d``: the same for the 3D stack (res1) only; subsumed by
      ``remat``.
    * ``preact_policy``: res blocks keep only their first conv's
      pre-activation for the backward (``layers.act_conv``); subsumed by
      ``remat``/``remat_3d`` where set.
    * ``scan_blocks``: accepted and runs the same loop. In JAX it runs each
      stack as one ``lax.scan``, whose only gain is compile time; PyTorch
      compiles nothing, so there is nothing to gain here.
    """

    out_channels: int = 1
    keep_prob: float = 1.0
    enc_channels: Tuple[int, int, int] = (8, 16, 32)
    res1_blocks: int = 10
    res2_blocks: int = 10
    res3_blocks: int = 5
    base: int = 32
    new_size: int = 128
    remat: bool = False
    remat_3d: bool = False
    preact_policy: bool = False
    scan_blocks: bool = False


_TRAIN_FIELDS = ("keep_prob", "remat", "remat_3d", "preact_policy", "scan_blocks")


class ShaderRenderNet(nn.Module):
    """The shader network on a camera-aligned voxel grid ``[B, H, W, D, C]``
    -> ``[B, 4H, 4W, out_channels]`` in [0, 1]. Runs in the dtype of its
    input; parameters stay float32."""

    def __init__(self, cfg: ShaderConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        g = generator
        c1, c2, c3 = cfg.enc_channels
        depth = -(-cfg.new_size // 2)  # e_conv1 halves depth, e_conv2 again
        nf = -(-depth // 2) * c3
        b = cfg.base
        s1 = (1, 1)
        enc = nn.ModuleDict()
        enc["e_conv1"] = ConvUnit("e_conv1", Conv(1, c1, (5, 5, 5), (2, 2, 2), g), c1)
        enc["e_conv2"] = ConvUnit("e_conv2", Conv(c1, c2, (3, 3, 3), (1, 1, 2), g), c2)
        enc["e_conv3"] = ConvUnit("e_conv3", Conv(c2, c3, (3, 3, 3), (1, 1, 1), g), c3)
        for i in range(1, cfg.res1_blocks + 1):
            enc[f"res1_{i}"] = ResBlock(c3, 3, g)
        enc["res1_skip"] = nn.ModuleDict({"con1_3X3": Conv(c3, c3, (3, 3, 3), (1, 1, 1), g)})
        enc["projection_unit"] = ProjectionUnit(nf, g)
        for i in range(1, cfg.res2_blocks + 1):
            enc[f"res2_{i}"] = ResBlock(nf, 2, g)
        enc["res2_skip"] = nn.ModuleDict({"con1_3X3": Conv(nf, nf, (3, 3), s1, g)})
        enc["e_conv5"] = ConvUnit("e_conv5", Conv(nf, b * 16, (4, 4), s1, g), b * 16)
        for i in range(1, cfg.res3_blocks + 1):
            enc[f"res3_{i}"] = ResBlock(b * 16, 2, g)
        enc["res3_skip"] = nn.ModuleDict({"con1_3X3": Conv(b * 16, b * 16, (3, 3), s1, g)})
        enc["e_conv6"] = ConvUnit("e_conv6", Conv(b * 16, b * 8, (4, 4), s1, g), b * 8)
        chain = [("e_conv7", b * 8, b * 4, 2), ("e_conv7_1", b * 4, b * 4, 1),
                 ("e_conv8", b * 4, b * 2, 2), ("e_conv9", b * 2, b, 2),
                 ("e_conv10", b, 16, 1)]
        for name, ci, co, s in chain:
            enc[name] = ConvUnit(name, ConvTranspose(ci, co, (4, 4), (s, s), g), co)
        # The head lives directly under "encoder" (no PReLU scope).
        enc["e_conv11"] = ConvTranspose(16, cfg.out_channels, (4, 4), s1, g)
        self.encoder = enc

    def _stack(self, prefix: str, n: int, x: torch.Tensor, remat: bool, preact: bool,
               shard: RowShard | None) -> torch.Tensor:
        """A residual stack, its skip conv and the fp32 shortcut add
        (``shader.py:106-116``)."""
        shortcut = x
        blocks = [self.encoder[f"{prefix}_{i}"] for i in range(1, n + 1)]
        x = res_block_stack(blocks, x, remat=remat, preact=preact, shard=shard)
        x = self.encoder[f"{prefix}_skip"]["con1_3X3"](x, shard=shard)
        return (x.float() + shortcut.float()).to(shortcut.dtype)

    def forward(self, vox: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                cfg: ShaderConfig | None = None, shard: RowShard | None = None,
                extended: bool = False) -> torch.Tensor:
        """``train`` turns dropout on (with ``keep_prob < 1``), drawing its
        masks from ``generator``, a generator on ``vox``'s device. ``cfg``,
        when given, supplies the training fields (keep_prob, remat,
        remat_3d, preact_policy, scan_blocks) in place of the network's
        own, as a JAX step passes its model config; its other fields must
        be the network's.

        ``shard``: ``vox`` is this rank's rows of the camera grid (a slab
        of ``H / m`` rows on a model axis of ``m``; ``extended``: with
        :data:`INPUT_HALO` rows above and below already in place, as the
        warp emits them), and the output is the rank's ``4 H / m`` image
        rows. Dropout masks are the rows of the whole run's masks."""
        e = self.encoder
        if cfg is None:
            cfg = self.cfg
        elif dataclasses.replace(cfg, **{f: getattr(self.cfg, f) for f in _TRAIN_FIELDS}) \
                != self.cfg:
            raise ValueError(f"cfg {cfg} does not describe this network ({self.cfg})")

        def unit(name, x, **kw):
            return dropout(e[name](x, shard=shard, **kw), cfg.keep_prob, generator, train,
                           shard=shard)

        pre = cfg.preact_policy
        with span("encoder3d"):
            x = unit("e_conv1", vox, **({"extended": True} if extended else {}))
            x = unit("e_conv3", unit("e_conv2", x))
            x = self._stack("res1", cfg.res1_blocks, x, cfg.remat or cfg.remat_3d, pre, shard)
        with span("projection"):
            x = e["projection_unit"](x)  # a 1x1 conv over (depth, channel): local in the rows
        with span("stack2d"):
            x = self._stack("res2", cfg.res2_blocks, x, cfg.remat, pre, shard)
            x = unit("e_conv5", x)
            x = self._stack("res3", cfg.res3_blocks, x, cfg.remat, pre, shard)
        with span("heads"):
            for name in ("e_conv6", "e_conv7", "e_conv7_1", "e_conv8", "e_conv9", "e_conv10"):
                x = unit(name, x)
            return torch.sigmoid(e["e_conv11"](x, shard=shard).float())


def slab_rows(shard: RowShard, patch: int) -> tuple:
    """(r0 - lo, r1 + hi): the camera-grid rows a rank warps for its slab
    [r0, r1) of a patch of ``patch`` rows, with :data:`INPUT_HALO` (lo, hi).
    The slabs must stay aligned to e_conv1's stride: ``patch`` must divide
    by 2 x the model axis, else ``ValueError``."""
    if patch % (2 * shard.size):
        raise ValueError(f"a patch of {patch} rows over a model axis of {shard.size}: the "
                         f"patch must divide by 2 x {shard.size}, so that every slab stays "
                         "aligned to e_conv1's stride")
    r0, r1 = shard.rows(patch)
    return r0 - INPUT_HALO[0], r1 + INPUT_HALO[1]


def camera_warp(grid: torch.Tensor, view_params: torch.Tensor, new_size: int,
                resample: str = "exact", compute_dtype: torch.dtype = torch.float32,
                shard: RowShard | None = None) -> torch.Tensor:
    """One camera-aligned warp of a ``[B, S, S, S, C]`` grid, differentiable
    where grad mode is on: "exact" (direct trilinear) or "multipass" (the
    pass plan on K1, K4 in its backward, in ``compute_dtype``). With
    ``shard``: only the rank's camera rows and e_conv1's halo
    (:func:`slab_rows`; the multipass path's last y pass emits just those
    rows)."""
    if resample not in ("exact", "multipass"):
        raise ValueError(f"resample must be 'exact' or 'multipass', got {resample!r}")
    with span("warp"):
        if shard is not None:
            args = (grid, view_params, (0, 0), new_size)
            rows = slab_rows(shard, new_size)
            if resample == "multipass":
                return rotate_resample_camera_patch_multipass(
                    *args, new_size=new_size, compute_dtype=compute_dtype, rows=rows)
            return rotate_resample_camera_patch(*args, new_size=new_size, rows=rows)
        if resample == "multipass":
            return rotate_resample_to_camera_multipass(grid, view_params, new_size=new_size,
                                                       compute_dtype=compute_dtype)
        return rotate_resample_to_camera(grid, view_params, new_size=new_size)


def shader_forward(
    net: ShaderRenderNet,
    voxels: torch.Tensor,
    view_params: torch.Tensor,
    *,
    train: bool = False,
    dropout_generator: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
    resample: str = "exact",
    mesh=None,
    gather: bool = False,
) -> torch.Tensor:
    """Render: rotate+resample -> axis align -> network, on the device of
    ``voxels``. ``resample``: "exact" (direct trilinear) or "multipass"
    (the pass plan on the K1 kernel, in ``compute_dtype``). Gradients flow
    to the network's parameters as PyTorch's grad mode allows (render under
    ``torch.no_grad()``); the resample runs outside autograd, as voxels and
    pose are data to the shader (the texture step is the path that
    differentiates a warp, through K4). ``train`` and
    ``dropout_generator``: see :meth:`ShaderRenderNet.forward`.

    ``mesh`` (``train.distributed.make_mesh``) with a model axis above 1:
    ``voxels`` is this rank's rows (axis 1) of the raw grid, which the
    ranks all-gather (a rotation mixes every axis); the rank warps its
    slab of the camera grid's rows with e_conv1's halo (:func:`slab_rows`;
    K1's last row pass emits just those rows) and returns its slab of the
    image rows, or with ``gather`` the whole image (every rank)."""
    from rendernet_tpu_torch.train.distributed import spatial_sharding

    with span("render"):
        shard = None
        if mesh is not None and mesh.shape["model"] > 1:
            shard = spatial_sharding(mesh, 5)
            voxels = shard.gather(voxels)
        with torch.no_grad():
            cam = camera_warp(voxels, view_params, net.cfg.new_size, resample, compute_dtype,
                              shard)
        out = net(cam.to(compute_dtype), train=train, generator=dropout_generator, shard=shard,
                  extended=shard is not None)
        return shard.gather(out) if gather and shard is not None else out


def init_shader_params(seed, cfg: ShaderConfig, device=None) -> ShaderRenderNet:
    """A freshly initialised network on ``device`` (CUDA unless the caller
    asks for the CPU). ``seed`` is an int or a CPU ``torch.Generator``."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    return ShaderRenderNet(cfg, gen).to(dev).eval()
