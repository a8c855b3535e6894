"""Share of its roofline of ``cinemri::normal_apply_bwd``, % (train)."""

from cinebench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "train", "normal_apply_bwd")
