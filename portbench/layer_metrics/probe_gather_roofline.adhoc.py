"""The fused probe's share of its roofline, in %: the bytes every
`repro_torch::probe_gather` call of the window needs (`portbench/roofline.py`)
at the card's peak bandwidth, over the device time of `probe_gather_kernel`."""


def read(ctx):
    return ctx.roofline("probe_gather")
