"""The shader network (``RenderNet_Shader.py:32-130``) and the texture/face
network (``RenderNet_Texture_Face_Normal.py:34-183``) as plain float32
PyTorch over a dict of weights named as the port names its parameters.

Activations are channels last (``[B, H, W, (D,) C]``). Convolutions are
TF-SAME; transposed convolutions are TF's (output = input x stride, the
adjoint of the SAME conv), both written here with ``F.conv*`` and explicit
pads and crops. Conv weights are ``(out, in) + kernel``, transposed-conv
weights ``(in, out) + kernel``, fully connected ``(out, in)``: PyTorch's
layouts. ``q`` is applied to both operands of every convolution and matrix
product: the identity for the reference, a lower precision for the control
(``reference/quant.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride, q: Callable = _ident):
    nd = w.dim() - 2
    pad = []
    for i in reversed(range(nd)):
        pad += list(same_pads(x.shape[1 + i], w.shape[2 + i], stride[i]))
    xc = F.pad(x.movedim(-1, 1), pad)
    y = (F.conv2d if nd == 2 else F.conv3d)(q(xc), q(w), None, tuple(stride))
    return y.movedim(1, -1) + b


def deconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride, q: Callable = _ident):
    nd = w.dim() - 2
    convt = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    y = convt(q(x.movedim(-1, 1)), q(w), None, tuple(stride))
    for i in range(nd):
        k, s = w.shape[2 + i], stride[i]
        y = y.narrow(2 + i, max(k - s, 0) // 2, x.shape[1 + i] * s)
    return y.movedim(1, -1) + b


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


class _Net:
    def __init__(self, p: Params, q: Callable):
        self.p, self.q = p, q

    def conv(self, name, x, stride):
        return conv(x, self.p[name + ".weight"], self.p[name + ".bias"], stride, self.q)

    def deconv(self, name, x, stride):
        return deconv(x, self.p[name + ".weight"], self.p[name + ".bias"], stride, self.q)

    def unit(self, scope, inner, x, stride, transpose=False):
        f = self.deconv if transpose else self.conv
        return prelu(f(f"{scope}.{inner}", x, stride), self.p[scope + ".alpha"])

    def stack(self, prefix, n, x, nd):
        s = (1,) * nd
        shortcut = x
        for i in range(1, n + 1):
            blk = f"{prefix}_{i}"
            net = prelu(self.conv(blk + ".con1_3X3", x, s), self.p[blk + ".alpha"])
            x = self.conv(blk + ".conv2_3x3", net, s) + x
        return self.conv(f"{prefix}_skip.con1_3X3", x, s) + shortcut

    def trunk(self, cam, cfg):
        """e_conv1-3, res1, the projection unit, res2, e_conv5, res3."""
        e = "encoder"
        x = self.unit(f"{e}.e_conv1", "e_conv1", cam, (2, 2, 2))
        x = self.unit(f"{e}.e_conv2", "e_conv2", x, (1, 1, 2))
        x = self.unit(f"{e}.e_conv3", "e_conv3", x, (1, 1, 1))
        x = self.stack(f"{e}.res1", cfg["res1_blocks"], x, 3)
        b, h, w, d, c = x.shape
        x = self.unit(f"{e}.projection_unit", "Conv", x.reshape(b, h, w, d * c), (1, 1))
        x = self.stack(f"{e}.res2", cfg["res2_blocks"], x, 2)
        x = self.unit(f"{e}.e_conv5", "e_conv5", x, (1, 1))
        return self.stack(f"{e}.res3", cfg["res3_blocks"], x, 2)


def shader_net(p: Params, cam: torch.Tensor, cfg: dict, q: Callable = _ident) -> torch.Tensor:
    """Camera-aligned grid ``[B, N, N, N, 1]`` -> image ``[B, 4N, 4N, 1]``
    in [0, 1]."""
    n = _Net(p, q)
    e = "encoder"
    x = n.trunk(cam, cfg)
    x = n.unit(f"{e}.e_conv6", "e_conv6", x, (1, 1))
    for name, s in (("e_conv7", 2), ("e_conv7_1", 1), ("e_conv8", 2), ("e_conv9", 2),
                    ("e_conv10", 1)):
        x = n.unit(f"{e}.{name}", name, x, (s, s), transpose=True)
    return torch.sigmoid(n.deconv(f"{e}.e_conv11", x, (1, 1)))


def texture_decoder(p: Params, z: torch.Tensor, cfg: dict, q: Callable = _ident):
    """Texture code ``[B, texture_dim]`` -> texture grid ``[B, G, G, G, 4]``."""
    t = "texture_encoder"
    g = cfg["tex_base"]
    x = torch.matmul(q(z), q(p[f"{t}.e_tex_fc1.fully_connected.weight"]).t()) \
        + p[f"{t}.e_tex_fc1.fully_connected.bias"]
    x = prelu(x, p[f"{t}.e_tex_fc1.alpha"]).reshape(z.shape[0], g, g, g, 4)
    n = _Net(p, q)
    x = n.unit(f"{t}.e_tex_conv0", "conv3d_transpose", x, (1, 1, 1), transpose=True)
    for name in decoder_doublings(cfg):
        x = n.unit(f"{t}.{name}", "conv3d_transpose", x, (2, 2, 2), transpose=True)
    return n.unit(f"{t}.e_tex_conv2", "conv3d", x, (1, 1, 1))


def decoder_doublings(cfg: dict):
    g, names = cfg["tex_base"], []
    while g < cfg["tex_grid"]:
        names.append("e_tex_conv1" if not names else f"e_tex_conv1_{len(names) + 1}")
        g *= 2
    return names


_HEADS = (("Image", "_1"), ("Normal", "_2"))


def _head_scopes(head: str, sfx: str):
    """(scope, inner name) of a head's e_conv6-10 (the reference's quirks:
    e_conv7's inner scope is e_conv7_2 in both heads, and the Image head's
    later deconvs sit under conv2d_transpose)."""
    s = f"encoder.{head}"
    inner = (lambda n: "conv2d_transpose") if sfx == "_1" else (lambda n: f"e_conv{n}{sfx}")
    return [(f"{s}.e_conv6{sfx}", f"e_conv6{sfx}"), (f"{s}.e_conv7{sfx}", "e_conv7_2"),
            (f"{s}.e_conv8{sfx}", inner(8)), (f"{s}.e_conv9{sfx}", inner(9)),
            (f"{s}.e_conv10{sfx}", inner(10))]


def texface_net(p: Params, cam: torch.Tensor, cfg: dict, q: Callable = _ident):
    """Camera-aligned ``[B, N, N, N, 5]`` (shape, then the texture grid's 4
    channels) -> (albedo, normal), each ``[B, 4N, 4N, 3]`` in [0, 1]."""
    n = _Net(p, q)
    trunk = n.trunk(cam, cfg)
    out = []
    for head, sfx in _HEADS:
        sc = _head_scopes(head, sfx)
        x = n.unit(*sc[0], trunk, (1, 1))
        for scope, inner in sc[1:4]:
            x = n.unit(scope, inner, x, (2, 2), transpose=True)
        out.append(torch.sigmoid(n.deconv(f"{sc[4][0]}.{sc[4][1]}", x, (1, 1))))
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter shapes, by the port's names
# ---------------------------------------------------------------------------
def _conv_shapes(spec, scope, inner, ci, co, k, alpha=True, transpose=False):
    w = (ci, co) + k if transpose else (co, ci) + k
    if alpha:
        spec[f"{scope}.alpha"] = (co,)
    spec[f"{scope}.{inner}.weight"] = w
    spec[f"{scope}.{inner}.bias"] = (co,)


def _trunk_shapes(spec, cfg, cin):
    e = "encoder"
    c1, c2, c3 = cfg["enc_channels"]
    k3, k2 = (3, 3, 3), (3, 3)
    _conv_shapes(spec, f"{e}.e_conv1", "e_conv1", cin, c1, (5, 5, 5))
    _conv_shapes(spec, f"{e}.e_conv2", "e_conv2", c1, c2, k3)
    _conv_shapes(spec, f"{e}.e_conv3", "e_conv3", c2, c3, k3)

    def stack(prefix, n, c, k):
        for i in range(1, n + 1):
            blk = f"{e}.{prefix}_{i}"
            spec[f"{blk}.con1_3X3.weight"] = (c, c) + k
            spec[f"{blk}.con1_3X3.bias"] = (c,)
            spec[f"{blk}.alpha"] = (c,)
            spec[f"{blk}.conv2_3x3.weight"] = (c, c) + k
            spec[f"{blk}.conv2_3x3.bias"] = (c,)
        spec[f"{e}.{prefix}_skip.con1_3X3.weight"] = (c, c) + k
        spec[f"{e}.{prefix}_skip.con1_3X3.bias"] = (c,)

    stack("res1", cfg["res1_blocks"], c3, k3)
    nf = -(-cfg["new_size"] // 4) * c3
    _conv_shapes(spec, f"{e}.projection_unit", "Conv", nf, nf, (1, 1))
    stack("res2", cfg["res2_blocks"], nf, k2)
    return nf, stack


def shader_shapes(cfg: dict) -> Dict[str, tuple]:
    spec: Dict[str, tuple] = {}
    e, b, k4 = "encoder", cfg["base"], (4, 4)
    nf, stack = _trunk_shapes(spec, cfg, 1)
    _conv_shapes(spec, f"{e}.e_conv5", "e_conv5", nf, b * 16, k4)
    stack("res3", cfg["res3_blocks"], b * 16, (3, 3))
    _conv_shapes(spec, f"{e}.e_conv6", "e_conv6", b * 16, b * 8, k4)
    for name, ci, co in (("e_conv7", b * 8, b * 4), ("e_conv7_1", b * 4, b * 4),
                         ("e_conv8", b * 4, b * 2), ("e_conv9", b * 2, b), ("e_conv10", b, 16)):
        _conv_shapes(spec, f"{e}.{name}", name, ci, co, k4, transpose=True)
    spec[f"{e}.e_conv11.weight"] = (16, cfg["out_channels"]) + k4
    spec[f"{e}.e_conv11.bias"] = (cfg["out_channels"],)
    return spec


def texface_shapes(cfg: dict) -> Dict[str, tuple]:
    spec: Dict[str, tuple] = {}
    t, g, k3 = "texture_encoder", cfg["tex_base"], (4, 4, 4)
    spec[f"{t}.e_tex_fc1.alpha"] = (g ** 3 * 4,)
    spec[f"{t}.e_tex_fc1.fully_connected.weight"] = (g ** 3 * 4, cfg["texture_dim"])
    spec[f"{t}.e_tex_fc1.fully_connected.bias"] = (g ** 3 * 4,)
    _conv_shapes(spec, f"{t}.e_tex_conv0", "conv3d_transpose", 4, 4, k3, transpose=True)
    for i, name in enumerate(decoder_doublings(cfg)):
        _conv_shapes(spec, f"{t}.{name}", "conv3d_transpose", 4 if i == 0 else 8, 8, k3,
                     transpose=True)
    _conv_shapes(spec, f"{t}.e_tex_conv2", "conv3d", 8, 4, k3)
    e, b, k4 = "encoder", cfg["base"], (4, 4)
    nf, stack = _trunk_shapes(spec, cfg, 5)
    _conv_shapes(spec, f"{e}.e_conv5", "e_conv5", nf, b * 8, k4)
    stack("res3", cfg["res3_blocks"], b * 8, (3, 3))
    for head, sfx in _HEADS:
        sc = _head_scopes(head, sfx)
        chans = ((b * 8, b * 4), (b * 4, b * 2), (b * 2, b), (b, 16), (16, 3))
        for j, ((scope, inner), (ci, co)) in enumerate(zip(sc, chans)):
            _conv_shapes(spec, scope, inner, ci, co, k4, alpha=j < 4, transpose=j > 0)
    return spec
