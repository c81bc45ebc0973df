"""The hand kernels' share of their roofline, in %: the summed least
time of every hand-kernel call in the traced window (``peaks.kernel_work``
at the shapes and nonzero slots the spy recorded) over the summed device
time of the hand kernels by name."""

from benchmark.trace import HAND_KERNEL


def read(run):
    if run.summary is None or run.spy is None:
        return None
    least = run.spy.bound_s()
    spent = run.summary.seconds_matching(HAND_KERNEL)
    if not least or spent <= 0.0:
        return None
    return 100.0 * least / spent
