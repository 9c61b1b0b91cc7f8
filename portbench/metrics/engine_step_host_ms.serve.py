"""Mean host time of one ``Engine.step`` over the window, in ms (the
harness's clock around the call; a resident burst syncs inside it)."""


def read(ctx):
    t = ctx["host"]["engine_step_s"]
    return 1e3 * sum(t) / len(t) if t else None
