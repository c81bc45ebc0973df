"""The card's kernel time over the window, per 1,000 users ranked, in
ms: what ranking the users costs the card's cores.  Copies are left
out: a copy from pageable host memory is staged by the host, so its time
on the card wanders with the host's speed as the rate does."""


def read(run):
    users = run.window.get("users")
    if run.ops is None or not users:
        return None
    ns = sum(op.dur_ns for op in run.ops if op.kind == "kernel")
    return 1e-3 * ns / users
