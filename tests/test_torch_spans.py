"""The port's span recorder (``utils/spans.py``) on the CPU: off it is one
shared no-op; on, a train step and a render record the span tree the
benchmark reads, with one unit a step, and change no number; under the
profiler each span lies on the trace's clock beside its ``rn.`` range."""
from __future__ import annotations

import contextlib
import json
from collections import Counter

import torch

from rendernet_tpu_torch.models import shader as ms
from rendernet_tpu_torch.models import texture_face as mt
from rendernet_tpu_torch.nn.layers import (Conv, ConvTranspose, ConvUnit, FullyConnected,
                                           ProjectionUnit, ResBlock)
from rendernet_tpu_torch.train import config, steps
from rendernet_tpu_torch.utils import spans

torch.set_num_threads(2)

SHADER = ms.ShaderConfig(new_size=32, enc_channels=(2, 4, 8), res1_blocks=1, res2_blocks=1,
                         res3_blocks=1, base=4)
TEXFACE = mt.TextureFaceConfig(texture_dim=12, tex_base=8, tex_grid=16, new_size=32,
                               enc_channels=(2, 4, 4), res1_blocks=1, res2_blocks=1,
                               res3_blocks=1, base=4)
# the model spans of one forward, in order, without ``weights``
SHADER_FWD = ["encoder3d", "projection", "stack2d", "heads"]
TEXFACE_FWD = ["encoder3d", "projection", "stack2d", "heads", "heads"]


def _tcfg(greyscale):
    return config.TrainConfig(batch_size=2, img_res=128, new_size=32, compute_dtype="float32",
                              e_eta=1e-3, decay_steps=2, is_greyscale=greyscale)


def _batch(seed, texface):
    g = torch.Generator().manual_seed(seed)
    vox = (torch.rand(2, 16, 16, 16, 1, generator=g) > 0.6).float()
    pose = torch.tensor([[0.3, 0.2, 1.0], [1.1, 0.5, 1.1]])
    img = torch.randint(0, 256, (2, 128, 128, 3 if texface else 1), generator=g,
                        dtype=torch.uint8)
    if not texface:
        return vox, img, pose
    nrm = torch.randint(0, 256, (2, 128, 128, 3), generator=g, dtype=torch.uint8)
    codes = torch.randn(2, TEXFACE.texture_dim, generator=g)
    return vox, img, nrm, codes, pose


def _train(texface, n, record):
    """``n`` steps from one seed's network, at patch 16 with fixed offsets:
    the losses, the final Adam state's moments, the parameters and the
    recording (or None)."""
    tcfg = _tcfg(greyscale=not texface)
    if texface:
        state, tx = steps.create_texture_state(3, TEXFACE, tcfg, device="cpu")
        step = steps.make_texture_train_step(TEXFACE, tcfg, tx, 16)
    else:
        state, tx = steps.create_shader_state(3, SHADER, tcfg, device="cpu")
        step = steps.make_shader_train_step(SHADER, tcfg, tx, 16)
    losses = []
    with spans.recording() if record else contextlib.nullcontext() as rec:
        for i in range(n):
            state, loss = step(state, *_batch(i, texface), 7, offsets=(4 * i, 8))
            losses.append(loss)
    adam = state.opt_state[0]
    params = {k: p.detach().clone() for k, p in state.params.named_parameters()}
    return losses, (adam.mu, adam.nu), params, state.params, rec


def _use_sites(net):
    """Parameter-use sites one forward reaches (preact off): every conv,
    deconv and FC casts its weights, every PReLU its alpha."""
    mods = list(net.modules())
    return (sum(isinstance(m, (Conv, ConvTranspose, FullyConnected)) for m in mods)
            + sum(isinstance(m, (ConvUnit, ResBlock, ProjectionUnit)) for m in mods))


def _children(rec, i):
    return [r.name for r in rec.spans if r.parent == i]


def test_off_is_one_shared_no_op_and_records_nothing():
    a, b = spans.span("train_step"), spans.span("weights")
    assert a is b
    with a as v:
        assert v is None
    _train(texface=False, n=1, record=False)
    with spans.recording() as rec:
        pass
    assert rec.spans == []


def test_train_steps_record_the_span_tree():
    for texface, fwd in ((False, SHADER_FWD), (True, TEXFACE_FWD)):
        *_, net, rec = _train(texface, 2, record=True)
        roots = [i for i, r in enumerate(rec.spans) if r.parent is None]
        assert [rec.spans[i].name for i in roots] == ["train_step"] * 2
        for unit, i in enumerate(roots, start=1):
            step = [r for r in rec.spans if r.unit == unit]
            kids = _children(rec, i)
            pre = ["loss", "decoder", "warp", "warp"] if texface else ["loss", "warp"]
            assert kids == pre + fwd + ["loss", "backward", "update"]
            names = Counter(r.name for r in step)
            assert names["backward"] == names["update"] == 1
            assert names["weights"] == _use_sites(net)
            for r in step:  # every weights span sits in a model span
                if r.name == "weights":
                    assert rec.spans[r.parent].name in fwd + ["decoder"]
                assert r.start_ns <= r.end_ns
        assert {r.unit for r in rec.spans} == {1, 2}


def test_renders_record_the_span_tree():
    vox, img, nrm, codes, pose = _batch(1, True)
    for texface in (False, True):
        if texface:
            net = mt.init_texture_face_params(3, TEXFACE, device="cpu")
            run = lambda: mt.texture_face_forward(net, vox, codes, pose)  # noqa: E731
            want = ["decoder", "warp", "warp"] + TEXFACE_FWD
        else:
            net = ms.init_shader_params(3, SHADER, device="cpu")
            run = lambda: ms.shader_forward(net, vox, pose)  # noqa: E731
            want = ["warp"] + SHADER_FWD
        with torch.no_grad(), spans.recording() as rec:
            run()
            run()
        roots = [i for i, r in enumerate(rec.spans) if r.parent is None]
        assert [rec.spans[i].name for i in roots] == ["render"] * 2
        assert [rec.spans[i].unit for i in roots] == [1, 2]
        for i in roots:
            assert _children(rec, i) == want
        assert Counter(r.name for r in rec.spans)["weights"] == 2 * _use_sites(net)


def test_recording_changes_no_number():
    for texface in (False, True):
        off = _train(texface, 2, record=False)
        on = _train(texface, 2, record=True)
        for a, b in zip(off[0], on[0]):
            assert torch.equal(a, b)
        for moments_off, moments_on in zip(off[1], on[1]):  # mu holds (1 - b1) x the gradient
            assert all(torch.equal(moments_off[k], moments_on[k]) for k in moments_off)
        assert all(torch.equal(off[2][k], on[2][k]) for k in off[2])
    vox, _, pose = _batch(2, False)
    net = ms.init_shader_params(3, SHADER, device="cpu")
    with torch.no_grad():
        plain = ms.shader_forward(net, vox, pose)
        with spans.recording():
            recorded = ms.shader_forward(net, vox, pose)
    assert torch.equal(plain, recorded)


def test_spans_lie_on_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    vox, _, pose = _batch(3, False)
    net = ms.init_shader_params(3, SHADER, device="cpu")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            for _ in range(2):
                ms.shader_forward(net, vox, pose)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    ranges = sorted((e for e in data["traceEvents"]
                     if e.get("ph") == "X" and e.get("name", "").startswith("rn.")),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == ["rn." + r.name for r in rec.spans]
    for e, r in list(zip(ranges, rec.spans))[1:]:
        assert e["tid"] == r.tid
        assert abs(e["ts"] - (r.start_ns - base) / 1e3) < 50
        assert abs(e["ts"] + e["dur"] - (r.end_ns - base) / 1e3) < 50


def test_the_loops_profile_window_names_the_layers(tmp_path):
    from rendernet_tpu_torch.train.loop import _ProfileWindow

    tcfg = config.TrainConfig(**{**_tcfg(True).__dict__, "profile_dir": str(tmp_path / "prof"),
                                 "profile_start_step": 1, "profile_steps": 1})
    state, tx = steps.create_shader_state(3, SHADER, tcfg, device="cpu")
    step = steps.make_shader_train_step(SHADER, tcfg, tx, 16)
    window = _ProfileWindow(tcfg)
    for i in range(3):
        window(i)
        state, _ = step(state, *_batch(i, False), 7, offsets=(0, 0))
    window.stop()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = Counter(e.get("name") for e in events)
    assert names["rn.train_step"] == 1 and names["rn.backward"] == 1
    assert names["rn.weights"] == _use_sites(state.params)
