"""Device events (kernels, copies, sets) per request launched inside the
program span ``cinemri.dc``, the cascades' data consistency, over the op
span's requests after its first (serve). A count of device work, not of
host launch calls: a CUDA graph's replay leaves it unchanged."""

from cinebench.harness.spans import span_events


def read(run):
    return span_events(run, "serve", "cinemri.dc")
