"""Share of the card's time idle while it trains, in %, without the
profiler's own cost: one less the device's busy time a step in the
traced stretch (the union of its kernels' intervals, which the profiler
does not lengthen) over the wall time a step of the window's untraced
rest. The traced stretch's own idle share would also count the host time
the profiler spends recording each operator (transformer_1b: 16-19%
there against 4% here)."""


def read(ctx):
    traced, after = ctx["traced"], ctx["after"]
    if (not traced["steps"] or not traced["device"] or not after["steps"]
            or after["seconds"] <= 0):
        return None
    busy = traced["attribution"]["busy_s"] / traced["steps"]
    return 100.0 * (1.0 - busy * after["steps"] / after["seconds"])
