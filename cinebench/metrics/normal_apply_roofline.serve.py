"""Share of its roofline of ``cinemri::normal_apply``, % (serve)."""

from cinebench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "serve", "normal_apply")
