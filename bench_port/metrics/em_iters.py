"""EM iterations a fit (``FitResult.n_iters``), mean over the window's
fits. Layer: the EM driver (``models/hmrf.py::fit``)."""


def read(ctx):
    fits = ctx["fits"]
    return sum(f["n_iters"] for f in fits) / len(fits) if fits else None
