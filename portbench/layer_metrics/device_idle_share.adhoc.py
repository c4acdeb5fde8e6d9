"""The share of the window in which no operation ran on the card, in %:
one less the union of the traced device operations over the window."""


def read(ctx):
    return ctx.idle_share() if ctx.trace.ops else None
