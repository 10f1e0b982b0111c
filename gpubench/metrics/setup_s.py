"""Seconds from the process's start to the window: imports, rendering and
writing the plate, weights, kernel builds or loads, one warm round."""


def read(ctx):
    return ctx["setup_s"]
