"""Seconds a fit spends capturing its L-BFGS solves as CUDA graphs: the
sum of ``GraphSolve.capture_s`` over the model's solves (init and M-step
shapes), mean over the timed fits; a program counter."""


def read(ctx):
    fits = ctx["timed"]
    if not fits:
        return None
    return sum(f["capture_s"] for f in fits) / len(fits)
