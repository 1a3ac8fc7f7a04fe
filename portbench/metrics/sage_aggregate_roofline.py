"""``sage_aggregate``'s share of its roofline, in %: the least bytes of each
call (``counts.sage_bytes``: A's nonzeros, the rows of H they reference,
the output) at HBM bandwidth, over the device time of the kernels launched
inside ``kernels.ops.sage_aggregate``. The nonzeros are those of the
clients' own edges, without the few imputed ones: a lower bound."""
from portbench import counts, peaks

SPANS = {"sage_aggregate": "repro_torch.kernels.ops:sage_aggregate"}


def read(ctx):
    spans = ctx["trace"].spans.get("sage_aggregate", [])
    device_s = sum(s.device_s for s in spans)
    if device_s <= 0:
        return None
    nnz, refs = ctx["shapes"].nnz, ctx["referenced_rows"]
    bound = 0.0
    for s in spans:
        m, n, d = s.shapes[1]
        bound += counts.sage_bytes(nnz, refs, d, m * n) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / device_s
