"""Seconds of ``train.ell_pair_cached`` in set-up, the card synchronised
after it (host clock)."""


def read(run):
    return run.setup.get("ell_build_s")
