"""Share of the traced window in which the card was idle while the
innermost open span of the program was the cascade's (``cascade.*``: its
rounds, host decisions and compact builds), in %."""

from benchmark import spans


def read(run):
    return spans.share_under(run, "cascade")
