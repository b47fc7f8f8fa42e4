"""Operation and byte counts against hand counts."""
import pytest

from portbench import registry, work


def test_k3_hand_count():
    # [2, 8, 6, 4] -> 3 channels: 2 * 4 * 3 = 24 tiles of 2x2, 16 products
    # each per (c, k) pair; bf16 reads x (384) + U (16*4*3) and writes 288.
    f, b = work.k3((2, 8, 6, 4), 3, "bfloat16")
    assert f == 2 * 16 * 24 * 4 * 3
    assert b == 2 * (2 * 8 * 6 * 4 + 16 * 4 * 3 + 2 * 8 * 6 * 3)


def test_k2_hand_count():
    # [1, 2, 3, 4, 5] -> 6: 24 positions x 27 taps x 5 x 6 products.
    f, b = work.k2((1, 2, 3, 4, 5), 6, "float32")
    assert f == 2 * 24 * 27 * 5 * 6
    assert b == 4 * (24 * 5 + 27 * 5 * 6 + 24 * 6)
    fw, bw = work.k2w((1, 2, 3, 4, 5), 6, "bfloat16")
    assert fw == f and bw == 2 * (24 * 5 + 24 * 6) + 4 * 27 * 5 * 6


def test_k1_hand_count():
    # 3 rows of 10 lanes to 7 output lanes, per bc, for 2 bc.
    f, b = work.k1(2, 3, 10, 7, "bfloat16")
    assert f == 10 * 2 * 3 * 7
    assert b == 2 * 2 * (3 * 10 + 3 * 7) + 16 * 2
    f4, _ = work.k4(2, 3, 10, 7, 6, "bfloat16")
    assert f4 == 2 * 3 * (10 * 6 * 10 + 8 * 7)


def test_bound_takes_the_larger():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_step_counts():
    """The shader's render request: the 1024-wide res2 stack dominates; a
    3x3 2-D conv counts 16 / 36 of its direct products."""
    cfg = registry.config("shader")
    layers = work.shader_layers(cfg, 8, 128)
    res2 = [l for l in layers if l.name.startswith("res2.")]
    assert len(res2) == 21 and all(l.m_out == 8 * 64 * 64 and l.ci == 1024 for l in res2)
    least, direct = work.layer_flops(res2[0])
    assert direct == 2.0 * 8 * 64 * 64 * 1024 * 1024 * 9 and least == direct * 16 / 36
    fwd = work.step_flops(layers, train=False)
    assert 8.0e12 < fwd["least"] < 9.5e12
    tr = work.step_flops(work.shader_layers(cfg, 24, 64), train=True)
    # a step is about three forwards at a quarter of the positions, times 3
    assert 2.5 < tr["least"] / (work.step_flops(work.shader_layers(cfg, 24, 64), False)["least"]) < 3.0
