"""device.idle_share: 1 - (the union of the device's operation intervals
over the traced window's length)."""


def read(run):
    if run.get("trace") is None:
        return None
    t = run["trace"]
    return 1.0 - t["busy_s"] / t["window_s"]
