"""Median host ms from the call into the port until it returns, device work
still queued, over the window's untraced items (train)."""

from cinebench.harness.readers import enqueue_ms


def read(run):
    return enqueue_ms(run, "train")
