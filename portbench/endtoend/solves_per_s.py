"""Instances returned certified (status ``Optimal``) by the window's
calls, over the whole window, from the first call's start to the last
one's result: a stack of 64 counts 64."""


def read(ctx):
    return ctx.certified / ctx.window_s
