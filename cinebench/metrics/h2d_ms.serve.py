"""Device ms per request of the request's copies to the device, inside the
program span ``cinemri.serve.h2d``, over the op span's requests after its
first (serve)."""

from cinebench.harness.spans import span_ms


def read(run):
    return span_ms(run, "serve", "cinemri.serve.h2d")
