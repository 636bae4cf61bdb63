"""Seconds of a fit's init (``PhyloHMRF.initialize``: k-means, the
cluster statistics, the captured init solve, its read-back), a span
synchronized on both ends, mean over the timed fits."""

from _common import span_total


def read(ctx):
    total, n = span_total(ctx["timed"], "initialize")
    return total / n if n else None
