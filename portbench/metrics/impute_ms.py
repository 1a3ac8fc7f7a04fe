"""Device milliseconds of the servers' imputation (embeddings, generator and
assessor training, X̅, the similarity top-k, patching), per profiled
imputation round."""
SPANS = {"impute": "repro_torch.core.strategies:SpreadImputation.impute"}


def read(ctx):
    spans = ctx["trace"].spans.get("impute", [])
    n = sum(ctx["trace_flags"])
    device_s = sum(s.device_s for s in spans)
    if device_s <= 0 or n == 0:
        return None
    return 1e3 * device_s / n
