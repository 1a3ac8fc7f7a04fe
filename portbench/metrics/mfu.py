"""Model FLOPs of the window's rounds (``counts.round_flops``) over the
window's time, as a share of the card's dense TF32 peak: the highest rate
at which it multiplies f32 inputs. Read from the unprofiled window of the
traced run."""
from portbench import counts, peaks


def read(ctx):
    flops = sum(counts.round_flops(ctx["shapes"], imp) for imp in ctx["impute_flags"])
    return 100.0 * flops / ctx["window_s"] / peaks.TF32_FLOPS
