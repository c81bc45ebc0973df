"""Device milliseconds (kernels, copies and sets) of the traced window
over the batches it ranked."""


def read(run):
    n = run.window.get("batches")
    if run.summary is None or not n:
        return None
    return 1e3 * run.summary.device_op_s / n
