"""NCCL kernels' device time a training step, in ms, over the traced
stretch."""

from portbench.yardstick import timeline


def read(ctx):
    traced = ctx["traced"]
    if not traced["steps"]:
        return None
    total = sum(ev.dur_ps for ev in traced["device"]
                if timeline.is_collective(ev.name))
    return 1e3 * total * 1e-12 / traced["steps"]
