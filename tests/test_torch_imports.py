"""Import guard: the PyTorch port stands alone beside the JAX package.

Importing every module of ``rendernet_tpu_torch`` in a fresh interpreter
must leave ``jax``, ``rendernet_tpu`` and ``tensorflow`` (which
``compat/pb_import.py`` imports only inside the function that parses a
GraphDef) out of ``sys.modules``, and no file of the port (nor
``chip_smoke.py`` or ``halo_transport.py``) may name the first two in an
import.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PKG = os.path.join(REPO, "rendernet_tpu_torch")

_PROBE = r"""
import importlib, json, pkgutil, sys
import rendernet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "rendernet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "rendernet_tpu"
             or m.startswith("rendernet_tpu.") or m == "tensorflow"
             or m.startswith("tensorflow."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("cli.demo", "cli.__main__", "cli.reconstruct", "compat.jax_params",
                "cli._train_common", "cli.train_shader", "cli.train_texture", "cli.pack_tar",
                "data", "data.loaders", "data.pose", "data.prefetch", "data.synthetic",
                "io._native_load", "io.native", "io.native_img", "io.tar_archive",
                "models.texture_face", "train.checkpoint", "train.loop", "utils.tb",
                "compat.tf_import", "io.binvox", "models.decoders", "recon", "recon.inverse",
                "models.shader", "nn.init", "nn.layers", "ops._native", "ops.conv_grad", "ops.crops",
                "ops.cuda_conv2d", "ops.cuda_conv3d", "ops.cuda_resample", "ops.cuda_winograd", "ops.phong",
                "ops.halo",
                "ops.resample", "ops.transforms", "ops.winograd", "train.config",
                "ops.phase_conv", "compat.frozen", "compat.pb_import", "cli.convert",
                "train.optim", "train.steps", "utils.image", "utils.spans", "train.distributed",
                "graft_entry"):
        assert f"rendernet_tpu_torch.{mod}" in res["modules"]


def test_every_kernel_source_is_built():
    """Each CUDA source of the port is one of the libraries the build starts
    (so chip_smoke.py's build covers every kernel), and nothing more."""
    from rendernet_tpu_torch.ops import _native

    sources = sorted(n[:-3] for n in os.listdir(os.path.join(PKG, "csrc")) if n.endswith(".cu"))
    assert sources == sorted(_native.SOURCES)
    assert {"conv3d_wgrad", "winograd_wgrad", "resample_bwd", "conv2d",
            "conv2d_wgrad"} <= set(sources)


def test_no_file_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax)|rendernet_tpu\.", re.M)
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "halo_transport.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
