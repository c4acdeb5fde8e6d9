"""Device time of all kernels of the window a query answered, in ms
(torch.profiler's kernel events)."""


def read(ctx):
    ks = ctx.kernels()
    if not ks or ctx.answered == 0:
        return None
    return sum(k[3] for k in ks) / 1e6 / ctx.answered
