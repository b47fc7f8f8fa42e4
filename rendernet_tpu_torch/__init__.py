"""rendernet_tpu_torch — the PyTorch/CUDA port of rendernet_tpu for NVIDIA Hopper.

The JAX package ``rendernet_tpu`` stays beside this one as the reference;
every module here mirrors the name of its JAX counterpart. Public functions
keep the JAX layouts (NHWC / NDHWC activations, HWIO / DHWIO weights) so the
two packages compare like with like. The three TPU kernels of the serving
path are hand-written CUDA C++ for sm_90a (``csrc/``), built with nvcc at
first use (``ops/_native.py``).

Importing the package is light: it imports no submodule, and none of it
imports JAX.
"""
from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; inside a process group, by default, the rank's own card
    (``train.distributed.rank_device``). Raises when CUDA is requested (or
    defaulted to) and absent."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if (device is None and torch.cuda.is_available() and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        from rendernet_tpu_torch.train.distributed import rank_device

        dev = rank_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rendernet_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
