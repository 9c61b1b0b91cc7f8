"""Mean host time of ``Trainer.train_step`` over the window, in ms: the
enqueue of a step's work (the harness's clock around the call)."""


def read(ctx):
    t = ctx["host"]["host_step_s"]
    return 1e3 * sum(t) / len(t) if t else None
