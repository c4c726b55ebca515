"""Counted work of the `attn` kernel family (bench/kernels/attn.json) in the
traced sub-window, as a share of its roofline time, over the family's
device time there."""


def read(run):
    return run.family_roofline("attn")
