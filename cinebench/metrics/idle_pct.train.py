"""Share of the traced window with no kernel, copy or set on the device, % (train)."""

from cinebench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "train")
