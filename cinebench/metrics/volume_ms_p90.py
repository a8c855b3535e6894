"""90th percentile over all requests of the window of the ms from the call
to ``serve(...)`` until the image is a host tensor."""

from cinebench.harness.stats import percentile


def read(run):
    if run.kind != "serve":
        return None
    return 1e3 * percentile([x["t2"] - x["t0"] for x in run.items], 90)
