"""Fields (1080^2 x 5 channels) turned into masks and profiles on disk a
second: the window's fields over the time of its passes (host clock)."""


def read(ctx):
    return ctx["window_fields"] / ctx["window_s"]
