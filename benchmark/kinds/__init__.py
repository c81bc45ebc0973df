"""The general drivers a traffic mix names by its ``kind``: each has
``setup(run)``, ``window(run, state, fault)``, ``release(run, state)``,
``check(run, judged, judge)`` and ``end_to_end(run)``."""
