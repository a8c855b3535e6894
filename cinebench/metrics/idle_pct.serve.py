"""Share of the traced window with no kernel, copy or set on the device, % (serve)."""

from cinebench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "serve")
