"""Model FLOPs of the window's rounds, as the cell's driver counts them
(``ctx["model_flops"]``; for ``fgl``, ``counts.round_flops``), over the
window's time, as a share of the card's dense peak in the cell's dtype
(``ctx["peak_flops"]``: TF32 for f32 inputs, bf16 for bf16). Read from the
unprofiled window of the traced run."""


def read(ctx):
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / ctx["peak_flops"]
