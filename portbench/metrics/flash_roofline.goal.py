"""The flash attention calls' share of their roofline in the traced goals:
the sum of each call's bound (``roofline.attention_bound_s``: q, k, v and
the mask read once and the output written once at the HBM rate, or
4 H L D FLOPs per valid key at the dense 16-bit peak, the larger) over the
sum of the flash kernels' device time in the trace. The bound does not
depend on which kernel serves the call."""
from portbench import idle

KERNELS = ("flash_split_kernel", "flash_tile_kernel")


def read(run):
    if run.events is None or not run.flash_calls:
        return None
    device_s = sum(float(e["dur"]) for e in idle.device_ops(run.events)
                   if any(k in e["name"] for k in KERNELS)) / 1e6
    return 100.0 * run.flash_bound_s / device_s if device_s > 0 else None
