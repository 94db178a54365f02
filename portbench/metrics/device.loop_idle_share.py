"""device.loop_idle_share: the share of the traced Compute phases in which
the device was idle under the program's ``lbm.ops.loop`` span (the run
loop launching the kernels) and no inner span, in %.  Nothing without a
trace that holds device work and the span."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or "lbm.ops.loop" not in t["idle_by_span"]:
        return None
    return 100.0 * t["idle_by_span"]["lbm.ops.loop"] / t["window_s"]
