"""Device time a training step, in ms: the union of every kernel's
interval over the traced stretch, over the steps traced."""


def read(ctx):
    traced = ctx["traced"]
    if not traced["steps"] or not traced["device"]:
        return None
    return 1e3 * traced["attribution"]["busy_s"] / traced["steps"]
