"""The served work's share of the card's bf16 peak, in %: the frozen
forward FLOPs (``yardstick/flops.py``) of the prompts answered and the
tokens delivered after the traced stretch, to the window's close, over
those seconds and 989 TFLOP/s: a rate without the profiler's own
cost."""

from portbench.yardstick import peaks


def read(ctx):
    if not ctx["flops"] or ctx["after_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["after_s"] / peaks.BF16_FLOPS
