"""``library_share.<train|render>``: the share of the device's kernel time
(the union of kernel intervals) spent in kernels that are not the port's
own: cuDNN's convolutions and weight gradients, PyTorch's elementwise,
reduction and copy kernels, the optimizer's per-tensor updates."""
from portbench import trace
from portbench.metrics import _roofline


def read(r, suffix):
    if suffix != r.kind:
        return None
    port = set(_roofline.PORT)
    lib = [s for s in r.trace.kernels if trace.kernel_name(s.name) not in port]
    total = trace.union_us(r.trace.kernels)
    return 100.0 * trace.union_us(lib) / total if total > 0 else None
