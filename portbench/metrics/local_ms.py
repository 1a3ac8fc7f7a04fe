"""Device milliseconds of the local training (T_l steps of forward,
backward and Adam over all clients), per profiled round."""
SPANS = {"local": "repro_torch.core.fedgl:FGLTrainer._local_rounds"}


def read(ctx):
    spans = ctx["trace"].spans.get("local", [])
    device_s = sum(s.device_s for s in spans)
    if device_s <= 0:
        return None
    return 1e3 * device_s / len(ctx["trace_flags"])
