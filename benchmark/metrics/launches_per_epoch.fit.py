"""CUDA kernels launched in the traced window over the epochs it
completed (every kernel of the profiler's trace, not only the hand
kernels)."""


def read(run):
    epochs = run.window.get("epochs")
    if run.summary is None or not epochs:
        return None
    return run.summary.launches / epochs
