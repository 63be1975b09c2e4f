"""Requests completed in the window, over the window's whole time."""


def read(run):
    return run.calls / run.window_s
