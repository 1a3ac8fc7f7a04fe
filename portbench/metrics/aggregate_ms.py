"""Device milliseconds of the aggregation (Eq. 16 or FedAvg), per profiled round."""
SPANS = {"aggregate": "repro_torch.core.fedgl:FGLTrainer.aggregate"}


def read(ctx):
    spans = ctx["trace"].spans.get("aggregate", [])
    device_s = sum(s.device_s for s in spans)
    if device_s <= 0:
        return None
    return 1e3 * device_s / len(ctx["trace_flags"])
