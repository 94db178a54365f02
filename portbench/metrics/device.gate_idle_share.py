"""device.gate_idle_share: the share of the traced Compute phases in which
the device was idle under the program's ``lbm.model.fit_check`` span (the
device-memory gate's query), in %.  Nothing without a trace that holds
device work and the span."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or "lbm.model.fit_check" not in t["idle_by_span"]:
        return None
    return 100.0 * t["idle_by_span"]["lbm.model.fit_check"] / t["window_s"]
