"""Collective device time that no compute kernel covers, a training
step, in ms (the timeline's exposed collective time)."""


def read(ctx):
    traced = ctx["traced"]
    if not traced["steps"]:
        return None
    return (1e3 * traced["attribution"]["exposed_collective_s"]
            / traced["steps"])
