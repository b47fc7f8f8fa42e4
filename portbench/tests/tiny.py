"""A small size at which the CPU tests drive the benchmark's modes: every
width cut, one res block a stack, batch 4 at patch 16 of a 32^3 camera
grid, 2 views a request."""
from portbench import registry

CFG = {
    "shader": dict(new_size=32, voxel_size=16, enc_channels=[2, 4, 8], res1_blocks=1,
                   res2_blocks=1, res3_blocks=1, base=4),
    "texface": dict(new_size=32, voxel_size=16, enc_channels=[2, 4, 4], res1_blocks=1,
                    res2_blocks=1, res3_blocks=1, base=4, tex_base=8, tex_grid=16),
}


def cell(name: str, dtype: str = "float32", **mix) -> dict:
    """The cell's file with a tiny mix, in ``dtype``; on the CPU the port's
    "auto" resample is the exact warp, so the multipass warp is asked for."""
    c = registry.workload(name)
    m = dict(c["mix"])
    m.update(shapes=4, pairs=8, texture_codes=4, batch=4, patch=16, max_steps=64, views=2,
             max_requests=64, traced_units=2, sample_requests=3, follow_steps=2)
    m.update(mix)
    return {"mix": m, "reference_chunk": 2, "resample": "multipass", "compute_dtype": dtype}


def cfg(name: str) -> dict:
    return CFG[registry.workload(name)["config"]]
