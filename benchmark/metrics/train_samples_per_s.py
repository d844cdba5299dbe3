"""Samples of every train step completed in the window, over the window's
seconds (it ends on a synchronize); under data parallelism the global
batch's samples."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["window"]["items"] / ctx["window"]["seconds"]
