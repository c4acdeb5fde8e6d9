"""The rank-find's share of its roofline, in %: the bytes every
`repro_torch::searchsorted` call of the window needs (`portbench/roofline.py`)
at the card's peak bandwidth, over the device time of `searchsorted_kernel`."""


def read(ctx):
    return ctx.roofline("searchsorted")
