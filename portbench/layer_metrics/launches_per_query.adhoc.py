"""Kernels the card ran in the window a query answered (torch.profiler's
kernel events)."""


def read(ctx):
    ks = ctx.kernels()
    if not ks or ctx.answered == 0:
        return None
    return len(ks) / ctx.answered
