"""Operations and bytes: per kernel launch, at its shapes, and per step of a
whole network; and the card's published peaks.

A launch's bound is the larger of its operations over the bf16 peak and its
bytes over the memory bandwidth (the arithmetic of ``chip_smoke.py``'s
``make_case`` and ``bound``). Operations are the least an exact
implementation needs: the 3x3 2-D convolutions as F(2x2, 3x3) Winograd
products (16 per 2x2 output tile, as K3 computes them), every other
convolution as direct products; bytes count each input read once and each
output written once.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense, at the 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

ITEM = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: operations or bytes, whichever
    binds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# per launch, keyed as the port's launch counters key them
# ---------------------------------------------------------------------------
def k3(shape: Tuple[int, int, int, int], k: int, dtype: str) -> Tuple[float, float]:
    """K3 (forward or data gradient) of ``x [B, H, W, C]`` to ``k`` channels:
    (operations, bytes). Reads x and the transformed weights U [16, C, k],
    writes [B, H, W, k]."""
    b, h, w, c = shape
    tiles = b * (h // 2) * (w // 2)
    item = ITEM[dtype]
    return 2.0 * 16 * tiles * c * k, item * (b * h * w * c + 16 * c * k + b * h * w * k)


def k2(shape: Tuple[int, int, int, int, int], co: int, dtype: str) -> Tuple[float, float]:
    """K2 (3x3x3 SAME conv, forward or data gradient) of ``[B, H, W, D, C]``
    to ``co`` channels."""
    m, c = math.prod(shape[:-1]), shape[-1]
    item = ITEM[dtype]
    return 2.0 * m * co * 27 * c, item * (m * c + 27 * c * co + m * co)


def k2w(shape: Tuple[int, int, int, int, int], co: int, dtype: str) -> Tuple[float, float]:
    """K2w: the weight gradient [3, 3, 3, C, co] (fp32) from x and gy."""
    m, c = math.prod(shape[:-1]), shape[-1]
    item = ITEM[dtype]
    return 2.0 * m * 27 * c * co, item * (m * c + m * co) + 4 * 27 * c * co


def k1(bc: int, r: int, lanes: int, ol: int, dtype: str) -> Tuple[float, float]:
    """K1: one interpolation pass [BC, R, L] -> [BC, R, ol] (10 operations
    an output: position, floor, weight, two masked taps)."""
    item = ITEM[dtype]
    return 10.0 * bc * r * ol, item * bc * (r * lanes + r * ol) + 16 * bc


def k4(bc: int, r: int, lanes: int, ol: int, taps: int, dtype: str) -> Tuple[float, float]:
    """K4: the pass's adjoint: reads v and g, writes gv and gp (fp32)."""
    item = ITEM[dtype]
    return (bc * r * (10.0 * taps * lanes + 8.0 * ol),
            item * bc * r * (2 * lanes + ol) + 4 * bc * r * ol + 16 * bc)


# ---------------------------------------------------------------------------
# a whole network's step
# ---------------------------------------------------------------------------
class Layer(NamedTuple):
    name: str
    kind: str  # "conv" | "deconv" | "fc"
    nd: int
    m_in: int  # input positions (batch included)
    m_out: int  # output positions
    ci: int
    co: int
    k: int  # taps per dim
    dgrad: bool  # whether a step needs its input's gradient


def layer_flops(l: Layer) -> Tuple[float, float]:
    """(forward operations counted least, direct) of one layer."""
    taps = l.k ** l.nd
    if l.kind == "fc":
        f = 2.0 * l.m_in * l.ci * l.co
        return f, f
    if l.kind == "deconv":  # every input position meets every tap
        f = 2.0 * l.m_in * l.ci * l.co * taps
        return f, f
    direct = 2.0 * l.m_out * l.ci * l.co * taps
    if l.nd == 2 and l.k == 3:
        return direct * 16.0 / 36.0, direct  # F(2x2, 3x3): 16 products per 4 outputs
    return direct, direct


def _trunk(cfg: dict, b: int, p: int, cin: int, dgrad_in: bool) -> Iterator[Layer]:
    """e_conv1 .. res3's skip at a camera patch ``p`` x ``p`` x new_size."""
    c1, c2, c3 = cfg["enc_channels"]
    n = cfg["new_size"]
    h = p // 2
    d1, d2 = n // 2, n // 4
    yield Layer("e_conv1", "conv", 3, b * p * p * n, b * h * h * d1, cin, c1, 5, dgrad_in)
    m1, m2 = b * h * h * d1, b * h * h * d2
    yield Layer("e_conv2", "conv", 3, m1, m2, c1, c2, 3, True)
    yield Layer("e_conv3", "conv", 3, m2, m2, c2, c3, 3, True)
    for i in range(2 * cfg["res1_blocks"] + 1):
        yield Layer(f"res1.{i}", "conv", 3, m2, m2, c3, c3, 3, True)
    nf = d2 * c3
    m = b * h * h
    yield Layer("projection_unit", "conv", 2, m, m, nf, nf, 1, True)
    for i in range(2 * cfg["res2_blocks"] + 1):
        yield Layer(f"res2.{i}", "conv", 2, m, m, nf, nf, 3, True)


def shader_layers(cfg: dict, b: int, p: int, dgrad_in: bool = False) -> List[Layer]:
    bb = cfg["base"]
    h = p // 2
    m = b * h * h
    out = list(_trunk(cfg, b, p, 1, dgrad_in))
    nf = (cfg["new_size"] // 4) * cfg["enc_channels"][2]
    out.append(Layer("e_conv5", "conv", 2, m, m, nf, bb * 16, 4, True))
    out += [Layer(f"res3.{i}", "conv", 2, m, m, bb * 16, bb * 16, 3, True)
            for i in range(2 * cfg["res3_blocks"] + 1)]
    out.append(Layer("e_conv6", "conv", 2, m, m, bb * 16, bb * 8, 4, True))
    side = h
    for name, ci, co, s in (("e_conv7", bb * 8, bb * 4, 2), ("e_conv7_1", bb * 4, bb * 4, 1),
                            ("e_conv8", bb * 4, bb * 2, 2), ("e_conv9", bb * 2, bb, 2),
                            ("e_conv10", bb, 16, 1), ("e_conv11", 16, cfg["out_channels"], 1)):
        out.append(Layer(name, "deconv", 2, b * side * side, b * (side * s) ** 2, ci, co, 4,
                         True))
        side *= s
    return out


def texface_layers(cfg: dict, b: int, p: int, train: bool) -> List[Layer]:
    """The texture decoder, the trunk and both heads; in training the
    decoder's and the warp's gradients are needed, so e_conv1 takes a data
    gradient."""
    g, n = cfg["tex_base"], cfg["new_size"]
    out = [Layer("e_tex_fc1", "fc", 0, b, b, cfg["texture_dim"], g ** 3 * 4, 1, False),
           Layer("e_tex_conv0", "deconv", 3, b * g ** 3, b * g ** 3, 4, 4, 4, True)]
    ci = 4
    while g < cfg["tex_grid"]:
        out.append(Layer(f"e_tex_conv1.{g}", "deconv", 3, b * g ** 3, b * (2 * g) ** 3, ci, 8, 4,
                         True))
        g, ci = 2 * g, 8
    out.append(Layer("e_tex_conv2", "conv", 3, b * g ** 3, b * g ** 3, 8, 4, 4, True))
    out += list(_trunk(cfg, b, p, 5, train))
    bb = cfg["base"]
    h = p // 2
    m = b * h * h
    nf = (n // 4) * cfg["enc_channels"][2]
    out.append(Layer("e_conv5", "conv", 2, m, m, nf, bb * 8, 4, True))
    out += [Layer(f"res3.{i}", "conv", 2, m, m, bb * 8, bb * 8, 3, True)
            for i in range(2 * cfg["res3_blocks"] + 1)]
    for head in ("Image", "Normal"):
        out.append(Layer(f"{head}.e_conv6", "conv", 2, m, m, bb * 8, bb * 4, 4, True))
        side = h
        for name, ci, co, s in (("e_conv7", bb * 4, bb * 2, 2), ("e_conv8", bb * 2, bb, 2),
                                ("e_conv9", bb, 16, 2), ("e_conv10", 16, 3, 1)):
            out.append(Layer(f"{head}.{name}", "deconv", 2, b * side * side,
                             b * (side * s) ** 2, ci, co, 4, True))
            side *= s
    return out


def step_flops(layers: List[Layer], train: bool) -> Dict[str, float]:
    """Operations of one forward, or one training step (forward, each
    layer's weight gradient, and the data gradient where one is needed),
    counted least and direct."""
    least = direct = 0.0
    for l in layers:
        f, d = layer_flops(l)
        mult = 1.0
        if train:
            mult += 1.0 + (1.0 if l.dgrad else 0.0)
        least += mult * f
        direct += mult * d
    return {"least": least, "direct": direct}
