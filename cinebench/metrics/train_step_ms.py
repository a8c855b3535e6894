"""The window's ms over the train steps completed in it."""

from cinebench.harness.stats import per_item_ms


def read(run):
    if run.kind != "train":
        return None
    return per_item_ms(len(run.items), run.window_s)
