"""Seconds of ``sparse.ingest`` in set-up (host clock)."""


def read(run):
    return run.setup.get("ingest_s")
