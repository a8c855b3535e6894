"""Device ms per request of the kernels launched inside the program span
``cinemri.dc``, the cascades' data consistency, over the op span's requests
after its first (serve)."""

from cinebench.harness.spans import span_ms


def read(run):
    return span_ms(run, "serve", "cinemri.dc")
