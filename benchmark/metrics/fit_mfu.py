"""The whole epoch's share of the card's peak, in %: the least time of
one epoch's required work (``peaks.epoch_least_s``, from the data's shape
alone) over the traced window's seconds an epoch; only on the card."""

from benchmark import peaks


def read(run):
    epochs = run.window.get("epochs")
    if not epochs or not run.shape or not run.device.startswith("cuda"):
        return None
    s = run.shape
    least = peaks.epoch_least_s(s["n_users"], s["n_items"], s["nnz"], s["k"])
    return 100.0 * least / (run.window["window_s"] / epochs)
