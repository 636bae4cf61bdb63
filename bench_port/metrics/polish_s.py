"""Seconds of the final polish (``_exact_labels_all`` after the EM loop:
the K1-K3 start and the expansion moves on the cut graphs), a span
synchronized on both ends, mean over the timed fits; nothing where the
fits have no polish."""

from _common import span_total


def read(ctx):
    total, n = span_total(ctx["timed"], "polish")
    return total / n if n else None
