"""Mean share of the engine's slots holding a request when a step
starts, over the window's steps, in %."""


def read(ctx):
    a = ctx["host"]["active"]
    return 100.0 * sum(a) / len(a) / ctx["max_batch"] if a else None
