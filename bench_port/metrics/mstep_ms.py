"""Milliseconds of an M-step: the spans of ``mstep_dispatch`` and
``mstep_finalize`` (each synchronized on both ends, so the solve's device
time falls in the dispatch), summed over the timed fits over the
M-steps dispatched."""

from _common import span_total


def read(ctx):
    total, n = span_total(ctx["timed"], "mstep_dispatch", "mstep_finalize")
    return 1e3 * total / n if n else None
