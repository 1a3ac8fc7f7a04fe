"""Device milliseconds of the generator's training (the AE and assessor
steps of Algorithm 1 lines 16-23), per profiled imputation round: the
kernels launched inside ``FGLTrainer._train_generator``, the body of the
port's ``fgl.impute.generator`` span. A part of ``impute_ms``."""
SPANS = {"generator": "repro_torch.core.fedgl:FGLTrainer._train_generator"}


def read(ctx):
    spans = ctx["trace"].spans.get("generator", [])
    n = sum(ctx["trace_flags"])
    device_s = sum(s.device_s for s in spans)
    if device_s <= 0 or n == 0:
        return None
    return 1e3 * device_s / n
