"""The program's blocking transfers between host and card in the traced
window (``profiling.host`` / ``to_device``, every site) over the epochs
it completed; only on the card."""


def read(run):
    epochs = run.window.get("epochs")
    if run.syncs is None or not epochs or not run.device.startswith("cuda"):
        return None
    return sum(n for n, _ in run.syncs.values()) / epochs
