"""conv.stage_ms_per_image (ms): device time of every operation of the
traced window but ``fused_mac_kernel`` (the conv stages' torch kernels:
encode, casts, plane-domain im2col, ReLU, decode; and the wave's copies
between host and card), per image served.  Moves
``conv_images_per_s``."""


def read(ctx):
    images = ctx.counters.get("images", 0)
    if not images:
        return None
    t = ctx.trace.kernel_s(lambda n: "fused_mac_kernel" not in n)
    return 1e3 * t / images
