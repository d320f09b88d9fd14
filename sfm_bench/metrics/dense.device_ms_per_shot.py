"""Milliseconds of device work (kernels and copies) a raw depthmap, from a
traced window."""


def read(run):
    shots = [it for it in run.items if it.get("kind") == "depthmap"]
    if run.trace is None or not run.trace.kernels or not shots:
        return None
    return 1e3 * run.trace.seconds() / len(shots)
