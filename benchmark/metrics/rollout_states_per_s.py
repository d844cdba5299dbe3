"""Predicted states (trajectories times autoregressive steps) of every
rollout completed in the window, over the window's seconds (it ends on a
synchronize)."""


def read(ctx):
    if ctx["kind"] != "rollout":
        return None
    return ctx["window"]["items"] / ctx["window"]["seconds"]
