"""Share of the traced window in which no operation ran on the card,
in %."""

from benchmark.trace import idle_share as read  # noqa: F401
