"""Mean host milliseconds from a call's start to its return in the traced
run's window (no synchronize inside the span): what the host spends
issuing one rollout."""


def read(ctx):
    host = ctx["window"]["host_call_s"]
    if ctx["kind"] != "rollout" or not host:
        return None
    return 1e3 * sum(host) / len(host)
