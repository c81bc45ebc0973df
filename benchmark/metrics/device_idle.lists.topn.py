"""Share of the traced window in which the card was idle while the
innermost open span of the program was ``topn.lists`` (the host lists of
seen items of a top-N request), in %."""

from benchmark import spans


def read(run):
    return spans.share_under(run, "topn.lists")
