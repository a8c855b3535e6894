"""The model's FLOP over the traced items, over the traced window at the
card's float32 peak, % (train)."""

from cinebench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run, "train")
