"""Users ranked over the traced window's wall: the batch job's rate,
bound by the host thread that builds the seen lists."""


def read(run):
    w = run.window
    if not w.get("window_s"):
        return None
    return w["users"] / w["window_s"]
