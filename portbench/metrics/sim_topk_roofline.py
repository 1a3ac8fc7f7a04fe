"""``sim_topk``'s share of its roofline, in %: for each call the larger of
its products over the cross-client pairs at the TF32 peak and its bytes
(H's real rows read, the lists written) at HBM bandwidth, over the device
time of the kernels launched inside ``kernels.ops.sim_topk``."""
from portbench import counts, peaks

SPANS = {"sim_topk": "repro_torch.kernels.ops:sim_topk"}


def read(ctx):
    spans = ctx["trace"].spans.get("sim_topk", [])
    device_s = sum(s.device_s for s in spans)
    if device_s <= 0:
        return None
    sh = ctx["shapes"]
    k = int(ctx["config"]["fgl"]["top_k_links"])
    bound = 0.0
    for s in spans:
        nb, n, c = s.shapes[0]
        bound += max(counts.sim_topk_ops(sh.cross_pairs, c) / peaks.TF32_FLOPS,
                     counts.sim_topk_bytes(sh.rows, c, nb * n, k) / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / device_s
