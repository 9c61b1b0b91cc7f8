"""Mean host time of the loader's next batch over the window, in ms
(the harness's clock around ``next``)."""


def read(ctx):
    t = ctx["host"]["data_wait_s"]
    return 1e3 * sum(t) / len(t) if t else None
