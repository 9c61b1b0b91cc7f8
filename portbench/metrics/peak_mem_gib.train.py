"""The allocator's peak over the window on the fullest card, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(ctx):
    peak = ctx.get("window_peak")
    return peak / 2 ** 30 if peak else None
