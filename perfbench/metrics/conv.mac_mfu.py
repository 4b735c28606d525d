"""conv.mac_mfu (%): the logic operations of every MAC served in the
traced window (``counts/conv.py``) over the window's seconds at the
32-bit logic peak (``counts/h100.json``).  Moves
``conv_images_per_s``."""
from counts import conv


def read(ctx):
    images = ctx.counters.get("images", 0)
    if not images or ctx.trace.window_s <= 0:
        return None
    peak = ctx.counts("h100")["logic_ops_per_s"]
    return 100.0 * conv.logic_ops(ctx.cfg, images) / (
        ctx.trace.window_s * peak)
