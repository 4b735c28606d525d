"""lm.hook_share (%): the share of the traced window's device time spent
in kernels launched under the ``perfbench.deq`` span, which the harness
puts around the dequant hook (``repro_torch.quant.apply.make_deq``, that
is ``quant/storage.py::dequantize``) it hands the model.  Moves
``lm_tok_s``."""


def read(ctx):
    hook = ctx.trace.spans.get("perfbench.deq")
    total = ctx.trace.kernel_s(lambda n: True)
    if not hook or total <= 0:
        return None
    return 100.0 * hook / total
