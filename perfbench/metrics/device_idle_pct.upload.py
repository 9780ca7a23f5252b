"""Share of the traced window in which no device op ran, in %."""

from perfbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
