"""The engine's program launches (its ``prefill_launches`` and
``decode_launches`` counters over the window) a delivered token."""


def read(ctx):
    return ctx["launches"] / ctx["delivered"] if ctx["delivered"] else None
