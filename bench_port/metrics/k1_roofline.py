"""K1's share of its roofline in the profiled fit, %: the least time of
its launches (``roofline.py``: bytes over 3.35 TB/s or float32 operations
over 67 TFLOP/s, from the buckets' shapes) over their device time in the
profiler. K1 runs one annealed mean field a bucket in every mean-field
E-step and in every exact labeling's start; the launches a temperature
come from the profiled count. Nothing where the count does not divide
evenly or no launch was recorded."""

import roofline

NAME = "mf_tile_kernel"


def read(ctx):
    p = ctx["profile"]
    if not p:
        return None
    recs = [v for n, v in p["kernels"].items() if NAME in n]
    seconds = sum(v[0] for v in recs)
    launches = sum(v[1] for v in recs)
    f = ctx["fits"][0]
    runs = f["estep_calls"] + f["exact_calls"]
    per = runs * len(ctx["buckets"]) * roofline.TEMPS
    if not launches or not per or launches % per:
        return None
    L = launches // per
    least = runs * sum(roofline.k1_mean_field_least_s(R, K, H, W, L)
                       for R, K, H, W in ctx["buckets"])
    return 100.0 * least / seconds
