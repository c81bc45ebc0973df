"""The general drivers a traffic mix names by its ``kind``: each is a file
``kinds/<kind>.py``, found by :func:`load`, with ``setup(run)``,
``window(run, state, fault)``, ``release(run, state)``, ``check(run,
judged, judge)`` and ``end_to_end(run)``; and, for the rehearsals and the
readings that set a limit, ``FAULTS`` (the names of the faults planted
under its timed call), ``fault(name)`` (the wrapper of the timed call
that plants one) and ``TINY`` (the configuration's keys at a rehearsal's
tiny size on the CPU, which a configuration's own ``tiny`` block
overrides)."""

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(kind: str):
    """The module of the traffic kind ``kind``."""
    path = HERE / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"no traffic kind {kind!r}: {path} not found")
    return importlib.import_module(f"{__name__}.{kind}")
