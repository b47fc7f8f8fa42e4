"""A kernel family's share of its roofline over a traced stretch: the sum of
each launch's bound (``work.bound_s`` at the shapes the port's counters
recorded) over the family's device time in the trace."""
from __future__ import annotations

from portbench import work

# The kernels' function names, as the trace gives them (csrc/*.cu).
K1 = ("k1_pass",)
K4 = ("k4_adjoint",)
K2 = ("conv3d_mma_kernel", "conv3d_tf32_kernel", "conv3d_core_kernel")
K2W = ("conv3d_wgrad_mma_kernel", "conv3d_wgrad_tf32_kernel", "conv3d_wgrad_reduce_kernel")
K3 = ("k3_gemm_fold", "k3_input_transform", "k3_input_transform_f32", "k3_weight_transform")
K6 = ("k6_gemm", "k6_input_transform", "k6_spread", "k6_fold")
K5 = ("conv2d_wgmma_kernel", "conv2d_tf32_kernel", "tf32_split_kernel")
K5W = ("wgrad_wgmma_kernel", "wgrad_tf32_kernel", "tf32_split_cmajor", "wgrad_reduce_kernel")
PORT = K1 + K4 + K2 + K2W + K3 + K6 + K5 + K5W

# counter family -> operations and bytes of one launch from its counter key
WORK = {
    "k3": lambda key, dt: work.k3(key[0], key[1], dt),
    "k2": lambda key, dt: work.k2(key[0], key[1], dt),
    "k2w": lambda key, dt: work.k2w(key[0], key[1], dt),
    "k1": lambda key, dt: work.k1(*key, dt),
    "k4": lambda key, dt: work.k4(*key, dt),
}


def share(r, names, families) -> float | None:
    """Percent of the roofline, or None where the stretch ran none of the
    family's kernels or counted none of its launches."""
    spans = r.kernels_named(set(names))
    t = sum(s.end - s.start for s in spans) * 1e-6
    bound = 0.0
    for fam in families:
        for key, count in r.launches.get(fam, {}).items():
            bound += count * work.bound_s(*WORK[fam](key, r.dtype))
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
