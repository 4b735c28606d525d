"""conv.fused_mac_roofline (%): the fused MAC kernel's frozen bound for
the traced window's MACs (``counts/conv.py``: the larger of the logic
operations at the 32-bit logic peak and the bytes at HBM's) over the
profiler's device time of ``fused_mac_kernel``.  Moves
``conv_images_per_s``."""
from counts import conv


def read(ctx):
    t = ctx.trace.kernel_s(lambda n: "fused_mac_kernel" in n)
    images = ctx.counters.get("images", 0)
    if t <= 0 or not images:
        return None
    return 100.0 * conv.fused_mac_bound_s(ctx.cfg, images) / t
