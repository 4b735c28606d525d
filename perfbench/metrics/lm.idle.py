"""lm.idle (%): the share of the traced window in which no operation
ran on the card.  Moves ``lm_tok_s``."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
