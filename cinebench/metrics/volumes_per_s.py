"""Volumes whose image reached host memory in the window, over the window's seconds."""


def read(run):
    if run.kind != "serve":
        return None
    return len(run.items) / run.window_s
