"""The whole step's share of the card's bf16 peak, in %: the frozen FLOP
count (``yardstick/flops.py``) of the samples of the steps run after
the traced stretch, over those seconds (to the window's closing
synchronise), the chips and 989 TFLOP/s: a rate without the profiler's
own cost."""

from portbench.yardstick import peaks


def read(ctx):
    after = ctx["after"]
    if not after["steps"] or after["seconds"] <= 0:
        return None
    work = (after["steps"] * ctx["batch_per_chip"] * ctx["chips"]
            * ctx["flops_per_sample"])
    return 100.0 * work / after["seconds"] / ctx["chips"] / peaks.BF16_FLOPS
