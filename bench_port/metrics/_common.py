"""Helpers the metric readers share: the spans of the timed fits."""


def span_total(fits, *names) -> tuple:
    """(summed seconds, number of calls) of the named spans over ``fits``
    (the first name's calls are the count)."""
    total = count = 0
    for f in fits:
        spans = f["spans"] or {}
        for i, n in enumerate(names):
            v = spans.get(n, [])
            total += sum(v)
            if i == 0:
                count += len(v)
    return total, count
