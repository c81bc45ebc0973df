"""Share of the window's tncg cascade rounds run on a compact sub-ELL
(uniform or profile plan), from ``train.CASCADE_TRACE``, in %."""


def read(run):
    rounds = run.window.get("cascade")
    if not rounds:
        return None
    compact = sum(r.structure.startswith("compact") for r in rounds)
    return 100.0 * compact / len(rounds)
