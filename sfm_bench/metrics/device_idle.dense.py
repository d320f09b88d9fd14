"""Share of a traced window of raw depthmaps in which no operation ran on
the device."""


def read(run):
    if run.trace is None or not run.trace.kernels or not any(
            it.get("kind") == "depthmap" for it in run.items):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
