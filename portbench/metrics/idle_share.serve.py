"""Share of the card's time idle while it serves, in %, without the
profiler's own cost: one less the device's busy time per delivered token
in the traced stretch over the wall time per token of the window's
untraced rest (the mix is the same all through the window)."""


def read(ctx):
    busy = ctx["traced"]["attribution"]["busy_s"]
    tokens = ctx["tokens"]
    if (not ctx["traced"]["device"] or not tokens["traced"]
            or not tokens["after"] or ctx["after_s"] <= 0):
        return None
    return 100.0 * (1.0 - busy / tokens["traced"] * tokens["after"]
                    / ctx["after_s"])
