"""Share of the profiled fit's wall time in which the card ran nothing:
1 - busy / window, busy the union of the profiler's kernel, copy and fill
intervals and the CUDA-event spans of the loop graphs' launches
(``devtrace.py``)."""


def read(ctx):
    p = ctx["profile"]
    if not p or p["window_s"] <= 0:
        return None
    return max(0.0, 1.0 - p["busy_s"] / p["window_s"])
