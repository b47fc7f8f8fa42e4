"""The fused Adam update on the CPU: ``optim.update_and_apply`` against
``tx.update`` + ``apply_updates``, the kernel wrapper's plain version, its
envelope checks, its chunk table walked as ``csrc/adam.cu`` walks it, and
the weight cast whose gradient comes back contiguous, as the kernel takes
it. The kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from rendernet_tpu_torch.nn import layers
from rendernet_tpu_torch.ops import _native, cuda_adam
from rendernet_tpu_torch.train import checkpoint as tckpt
from rendernet_tpu_torch.train import optim
from rendernet_tpu_torch.train.steps import TrainState

SHAPES = {"w": (3, 5), "b": (5,), "one": (1,), "big": (2, 4097)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in SHAPES.items()}


def _grads(rng, dtype=torch.float32):
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for k, s in SHAPES.items()}


def _leaves(state):
    return tckpt._flatten(state)[1]


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_steps", [2, 0])
def test_update_and_apply_equals_update_then_apply(moment_dtype, decay_steps):
    """On CPU tensors update_and_apply is tx.update then apply_updates, bit
    for bit, over six steps (a staircase that steps every 2, or none)."""
    tx = optim.make_optimizer(1e-3, decay_steps, 0.5, moment_dtype=moment_dtype)
    pa, pb = _params(), _params()
    sa, sb = tx.init(pa), tx.init(pb)
    rng = np.random.default_rng(1)
    for _ in range(6):
        g = _grads(rng)
        updates, sa = tx.update(g, sa, pa)
        optim.apply_updates(pa, updates)
        sb = optim.update_and_apply(tx, g, sb, pb)
    assert all(_same(pa[k], pb[k]) for k in SHAPES)
    la, lb = _leaves(sa), _leaves(sb)
    assert len(la) == len(lb) and all(_same(a, b) for a, b in zip(la, lb))
    assert int(sb[0].count) == int(sb[1].count) == 6


def test_fused_form_is_read_from_the_structure():
    """make_optimizer's Adam carries its in-place apply; reject_nonfinite
    around it, or a chain built by hand, does not. On the CPU
    update_and_apply never runs the apply."""
    tx = optim.make_optimizer(1e-3, 2, 0.5, b1=0.5, b2=0.999, eps=1e-8)
    assert tx.apply is not None
    assert optim.make_optimizer(1e-3, 2, 0.5, skip_nonfinite=1).apply is None
    assert optim.chain(optim.scale_by_adam(),
                       optim.scale_by_learning_rate(lambda c: 1e-3)).apply is None

    def apply(grads, state, params):
        raise AssertionError("the in-place apply ran on CPU tensors")

    params = _params()
    tx = tx._replace(apply=apply)
    state = optim.update_and_apply(tx, _grads(np.random.default_rng(6)), tx.init(params), params)
    assert int(state[0].count) == int(state[1].count) == 1


def test_update_and_apply_rejects_a_nonfinite_step():
    """With skip_nonfinite the step takes the generic path: a non-finite
    gradient leaves parameters and moments as they were and counts one."""
    tx = optim.make_optimizer(1e-3, 2, 0.5, skip_nonfinite=1)
    params = _params()
    state = tx.init(params)
    rng = np.random.default_rng(2)
    state = optim.update_and_apply(tx, _grads(rng), state, params)
    before = {k: p.clone() for k, p in params.items()}
    inner = [t.clone() for t in _leaves(state.inner_state)]
    g = _grads(rng)
    g["w"][1, 2] = float("nan")
    state = optim.update_and_apply(tx, g, state, params)
    assert all(_same(before[k], params[k]) for k in SHAPES)
    assert all(_same(a, b) for a, b in zip(inner, _leaves(state.inner_state)))
    assert int(state.notfinite_count) == 1 and int(state.total_notfinite) == 1
    state = optim.update_and_apply(tx, _grads(rng), state, params)
    assert int(state.notfinite_count) == 0 and int(state.total_notfinite) == 1
    assert not _same(before["w"], params["w"])


def test_checkpoint_round_trip_after_update_and_apply(tmp_path):
    """The state update_and_apply returns flattens, saves and restores
    leaf for leaf, and the restored run continues bit-equal."""
    tx = optim.make_optimizer(1e-3, 2, 0.5, moment_dtype="bfloat16")
    net = torch.nn.Linear(6, 3)
    params = dict(net.named_parameters())
    state = TrainState(net, tx.init(params), 0)
    rng = np.random.default_rng(3)

    def grads():
        return {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
                for k, p in params.items()}

    for step in range(3):
        state = TrainState(net, optim.update_and_apply(tx, grads(), state.opt_state, params),
                           step + 1)
    path = str(tmp_path / "ckpt.pt")
    tckpt.save_checkpoint(path, state)
    fresh_net = torch.nn.Linear(6, 3)
    fresh = TrainState(fresh_net, tx.init(dict(fresh_net.named_parameters())), 0)
    restored = tckpt.restore_checkpoint(path, fresh)
    assert restored.step == 3
    la, lb = _leaves(state.opt_state), _leaves(restored.opt_state)
    assert len(la) == len(lb) and all(_same(a, b) for a, b in zip(la, lb))
    g = grads()
    sa = optim.update_and_apply(tx, g, state.opt_state, params)
    sb = optim.update_and_apply(tx, g, restored.opt_state, dict(fresh_net.named_parameters()))
    assert all(_same(a, b) for a, b in zip(_leaves(sa), _leaves(sb)))
    assert all(_same(p, q) for p, q in zip(net.parameters(), fresh_net.parameters()))


def test_adam_source_is_built():
    assert "adam" in _native.SOURCES


@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lr_kind", ["tensor", "float"])
def test_wrapper_plain_version_equals_the_per_tensor_form(gdt, mdt, lr_kind):
    """cuda_adam.adam_plain, the kernel's plain version (in place), equals
    scale_by_adam, the learning-rate scale and apply_updates bit for bit,
    for each gradient and moment dtype."""
    b1, b2, eps = 0.5, 0.999, 1e-8
    schedule = optim.exponential_staircase(1e-3, 2 if lr_kind == "tensor" else 0, 0.5)
    tx = optim.chain(optim.scale_by_adam(b1, b2, eps, moment_dtype=mdt),
                     optim.scale_by_learning_rate(schedule))
    pa, pb = _params(), _params()
    sa, sb = tx.init(pa), tx.init(pb)
    rng = np.random.default_rng(4)
    for _ in range(4):
        g = _grads(rng, gdt)
        updates, sa = tx.update(g, sa, pa)
        optim.apply_updates(pa, updates)
        adam, sched = sb
        count, bc1, bc2 = optim._bias_corrections(adam.count, b1, b2)
        lr = -schedule(sched.count)
        names = list(pb)
        cuda_adam.adam_plain([pb[k] for k in names], [g[k] for k in names],
                             [adam.mu[k] for k in names], [adam.nu[k] for k in names], bc1, bc2,
                             lr, b1=b1, b2=b2, eps=eps)
        sb = (optim.AdamState(count, adam.mu, adam.nu), optim.ScheduleState(sched.count + 1))
    assert all(_same(pa[k], pb[k]) for k in SHAPES)
    assert all(_same(a, b) for a, b in zip(_leaves(sa), _leaves(sb)))


def test_envelope_checks():
    """The checks the CUDA path runs before a launch raise outside the
    kernel's envelope (fp16 gradients, bf16 parameters, non-contiguous
    tensors, mixed gradient dtypes, mismatched sizes) and pass inside it."""
    p = [torch.zeros(4, 3), torch.zeros(5)]
    g = [torch.zeros(4, 3), torch.zeros(5)]
    m = [torch.zeros(4, 3), torch.zeros(5)]
    v = [torch.zeros(4, 3), torch.zeros(5)]
    one = torch.ones(())
    assert cuda_adam._check(p, g, m, v, (one, one, -1e-3)) == (torch.float32, torch.float32)
    bad = [
        (p, [x.half() for x in g], m, v, TypeError),
        ([x.bfloat16() for x in p], g, m, v, TypeError),
        (p, [g[0].t().contiguous().t(), g[1]], m, v, ValueError),
        (p, [g[0], g[1].bfloat16()], m, v, TypeError),
        (p, [g[0], torch.zeros(6)], m, v, ValueError),
        (p, g[:1], m, v, ValueError),
    ]
    for pp, gg, mm, vv, err in bad:
        with pytest.raises(err):
            cuda_adam._check(pp, gg, mm, vv, (one, one, -1e-3))
    with pytest.raises(ValueError):
        cuda_adam._check(p, g, m, v, (one.double(), one, -1e-3))


def test_kernel_wrapper_refuses_cpu_tensors():
    """adam_ is the kernel's wrapper alone: CPU tensors raise before any
    launch (update_and_apply keeps them on tx.update + apply_updates)."""
    p, g, m, v = ([torch.zeros(4, 3)] for _ in range(4))
    one = torch.ones(())
    before = cuda_adam.launches
    with pytest.raises(ValueError):
        cuda_adam.adam_(p, g, m, v, one, one, -1e-3, b1=0.5, b2=0.999, eps=1e-8)
    assert cuda_adam.launches == before and torch.equal(p[0], torch.zeros(4, 3))


@pytest.mark.parametrize("numels", [[1, 3, 5, 4097], [cuda_adam.CHUNK * 3 + 7, 0, 2, 40000]])
@pytest.mark.parametrize("p_offsets", [(0, 0, 0, 0), (1, 3, 2, 5)])
def test_chunk_walk_covers_every_element_once(numels, p_offsets):
    """The chunk table, walked as the kernel walks it (per chunk: scalars up
    to the parameter's first 16-byte boundary, groups of four, scalars
    after), touches every element of every tensor once, and every group's
    parameter vector lies on 16 bytes, at any element offset of the
    parameter."""
    table = cuda_adam.chunk_table(numels)
    assert table.dtype == np.int32 and table.shape[1] == 2
    seen = [np.zeros(n, np.int64) for n in numels]
    chunk = cuda_adam.CHUNK
    for t, s0 in table:
        n = numels[t]
        addr = 256 + 4 * p_offsets[t]  # the parameter's byte address, 4-aligned
        e = min(s0 + chunk, n)
        a = min(s0 + ((16 - (addr + 4 * s0) % 16) % 16) // 4, e)
        b = a + ((e - a) & ~3)
        seen[t][s0:a] += 1
        seen[t][b:e] += 1
        for i in range(a, b, 4):
            assert (addr + 4 * i) % 16 == 0
            seen[t][i:i + 4] += 1
    assert all((s == 1).all() for s in seen)
    assert len(table) == sum(-(-n // chunk) for n in numels)


@pytest.mark.parametrize("shape", [(6, 5), (8, 6, 3, 3), (4, 3, 3, 3, 3)])
def test_weight_cast_returns_a_contiguous_gradient(shape):
    """layers.jax_layout_weight: the same cast as to_jax_layout(w).to(bf16)
    (values and strides), and a gradient of the same values that comes
    back contiguous in w's layout, as the fused update takes it."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal(shape[2:] + shape[1::-1]).astype(np.float32))
    got = layers.jax_layout_weight(w, torch.bfloat16)
    want = layers.to_jax_layout(w).to(torch.bfloat16)
    assert _same(got, want) and got.stride() == want.stride()
    (g_got,) = torch.autograd.grad(got, w, cot.bfloat16())
    (g_want,) = torch.autograd.grad(want, w, cot.bfloat16())
    assert torch.equal(g_got, g_want) and g_got.dtype == torch.float32
    assert g_got.is_contiguous()
    with torch.no_grad():
        assert _same(layers.jax_layout_weight(w, torch.bfloat16), want)
    assert layers.jax_layout_weight(w, torch.float32).data_ptr() == w.data_ptr()
