"""The 90th percentile of the window's round times (host clock, each round
ending in ``torch.cuda.synchronize()``), linear interpolation."""
import numpy as np


def read(ctx):
    return float(np.quantile(np.asarray(ctx["round_times"], dtype=np.float64), 0.9))
