"""Per cent of a window call's wall time (the traced run's unprofiled
window, seconds over calls) in which the device ran nothing: 100 (1 -
busy / wall), busy the union of device operations of a profiled call."""


def read(ctx):
    prof = ctx["profile"]
    if ctx["kind"] != "train" or not prof or prof["busy_s"] <= 0:
        return None
    wall = ctx["window"]["seconds"] / ctx["window"]["calls"]
    return 100.0 * max(0.0, 1.0 - prof["busy_s"] / prof["calls"] / wall)
