"""Share of the traced window in which the card was idle while the
innermost open span of the program was a solver's (``solver.*``: the
solvers' loops and their host tests), in %."""

from benchmark import spans


def read(run):
    return spans.share_under(run, "solver")
