"""lm.mfu (%): model FLOPs of the tokens generated in the traced window
(``counts/lm.py``) over the window's seconds at the bfloat16 dense peak
(``counts/h100.json``).  Moves ``lm_tok_s``."""
from counts import lm


def read(ctx):
    c = ctx.counters
    if not c.get("tokens") or ctx.trace.window_s <= 0:
        return None
    peak = ctx.counts("h100")["bf16_flops_per_s"]
    return 100.0 * lm.flops(ctx.cfg, c["tokens"], c["ctx_sum"]) / (
        ctx.trace.window_s * peak)
