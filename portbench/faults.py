"""Faults planted in the port underneath the timed path, for the check's
tests (``tests/test_pb_faults.py``, on the CPU) and for reading what a
fault does to the compared numbers at a cell's own size on the card
(``control.py --fault``):

* ``unchanged``: the training step returns its state unchanged;
* ``half_batch``: half of the batch left out: the step's mean is taken over
  the first half, a render serves the first half's images twice;
* ``answer``: an answer altered where it is produced: the step's loss times
  1.5, a corner of every served image raised by 0.25.
"""
from __future__ import annotations

import torch

TRAIN = ("unchanged", "half_batch", "answer")
RENDER = ("half_batch", "answer")


def plant(kind: str, model: str, fault: str, setattr_=setattr) -> None:
    """Plant ``fault`` for a ``kind`` ("train" or "render") cell of
    ``model``; ``setattr_`` (pytest's ``monkeypatch.setattr`` in tests)
    makes the change."""
    if kind == "train":
        from rendernet_tpu_torch.train import steps

        apply = steps._apply_step

        def broken(state, tx, batch, accum, micro_loss, mesh, allreduce_dtype):
            if fault == "unchanged":
                loss = micro_loss(slice(0, batch)).detach()
                return steps.TrainState(state.params, state.opt_state, state.step + 1), loss
            if fault == "half_batch":
                return apply(state, tx, batch // 2, accum, micro_loss, mesh, allreduce_dtype)
            if fault == "answer":
                return apply(state, tx, batch, accum, lambda sl: 1.5 * micro_loss(sl), mesh,
                             allreduce_dtype)
            raise ValueError(fault)

        setattr_(steps, "_apply_step", broken)
        return
    from rendernet_tpu_torch.models import shader, texture_face

    mod, attr = (shader, "shader_forward") if model == "shader" else \
        (texture_face, "texture_face_forward")
    fwd = getattr(mod, attr)

    def broken_render(net, vox, *rest, **kw):
        if fault == "half_batch":
            h = vox.shape[0] // 2
            out = fwd(net, vox[:h], *(r[:h] for r in rest), **kw)
            outs = out if isinstance(out, tuple) else (out,)
            outs = tuple(torch.cat([o, o], 0) for o in outs)
            return outs if isinstance(out, tuple) else outs[0]
        if fault != "answer":
            raise ValueError(fault)
        out = fwd(net, vox, *rest, **kw)
        for o in (out if isinstance(out, tuple) else (out,)):
            o[:, :4, :4] += 0.25
        return out

    setattr_(mod, attr, broken_render)
