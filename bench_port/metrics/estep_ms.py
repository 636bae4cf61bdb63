"""Milliseconds of an E-step: the span of ``estep`` (dispatch and, since
it is synchronized, its device work; in an exact labeler's cell the
exact moves inside it) and of its read-back's ``collect``, summed over
the timed fits over the E-steps dispatched."""

from _common import span_total


def read(ctx):
    total, n = span_total(ctx["timed"], "estep", "estep_collect")
    return 1e3 * total / n if n else None
