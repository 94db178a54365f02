"""device.idle_share: the share of the traced Compute phases in which no
kernel, copy or set ran on the device, in %.  Nothing without a trace."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
