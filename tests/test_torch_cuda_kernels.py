"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import) when
there is no CUDA device. On a machine with an H100 and nvcc they build the
kernels from ``src/repro_torch/kernels/csrc`` and run them:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: ``sage_aggregate`` sums up to n products per output in another
order than cuBLAS, so values agree within 1e-5 absolute plus 1e-5 relative;
``sim_topk`` scores within 1e-5 and indices exact except between candidates
whose scores lie within 1e-5 (``torch_parity.assert_topk_match``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import sage_aggregate as ksage
from repro_torch.kernels import sim_topk as ksim
from torch_parity import assert_topk_match, gram_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _adj(gen, m, n, dev):
    a = (torch.rand((m, n, n), generator=gen, device=dev) < 0.05).float()
    a[:, 0] = 0.0                              # an isolated row: the clamp matters
    return a * torch.rand((m, n, n), generator=gen, device=dev) * 2


@pytest.mark.parametrize("m,n,d", [(3, 1001, 77), (2, 130, 129), (1, 5, 1), (6, 257, 32)])
def test_sage_forward_matches_plain(dev, m, n, d):
    gen = torch.Generator(device=dev).manual_seed(n)
    adj = _adj(gen, m, n, dev)
    h = torch.randn((m, n, d), generator=gen, device=dev)
    before = ksage.launches
    got = ops.sage_aggregate(adj, h)
    torch.cuda.synchronize()
    assert ksage.launches == before + 1
    torch.testing.assert_close(got, ref.sage_aggregate(adj, h), atol=1e-5, rtol=1e-5)


def test_sage_grads_match_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    adj = _adj(gen, 3, 300, dev)
    h = torch.randn((3, 300, 20), generator=gen, device=dev)
    g = torch.randn((3, 300, 20), generator=gen, device=dev)
    grads = []
    for fn in (ops.sage_aggregate, ref.sage_aggregate):
        a = adj.clone().requires_grad_(True)
        x = h.clone().requires_grad_(True)
        torch.sum(fn(a, x) * g).backward()
        grads.append((a.grad, x.grad))
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-5, rtol=1e-5)


def test_sage_input_without_grad_gets_none(dev):
    """Layer 1's features need no gradient, and the backward computes none."""
    adj = torch.rand((2, 50, 50), device=dev)
    x = torch.randn((2, 50, 8), device=dev)
    w = torch.randn((8, 3), device=dev, requires_grad=True)
    torch.sum(ops.sage_aggregate(adj, x) @ w).backward()
    assert x.grad is None and w.grad is not None


def _sim(gen, nb, n, c, dev):
    h = torch.randn((nb, n, c), generator=gen, device=dev)
    h[:, 11] = h[:, 3]                         # exact duplicates: exact ties
    h[:, 40] = h[:, 3]
    cid = torch.repeat_interleave(torch.arange(4, dtype=torch.int32, device=dev),
                                  (n + 3) // 4)[:n]
    mask = (torch.rand((nb, n), generator=gen, device=dev) < 0.8).float()
    return h, cid, mask


@pytest.mark.parametrize("nb,n,c,k,off", [(3, 1237, 7, 4, 0), (1, 200, 15, 16, 0),
                                          (2, 129, 1, 3, 500)])
def test_sim_topk_matches_plain(dev, nb, n, c, k, off):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    h, cid, mask = _sim(gen, nb, n, c, dev)
    before = ksim.launches
    kv, ki = ops.sim_topk(h, cid, mask, k, col_offset=off)
    torch.cuda.synchronize()
    assert ksim.launches == before + 1
    rv, ri = ref.sim_topk(h, cid, mask, k, col_offset=off)
    unshift = lambda i: np.where(i >= 0, i - off, -1)  # noqa: E731
    assert_topk_match(kv.cpu().numpy(), unshift(ki.cpu().numpy()), rv.cpu().numpy(),
                      unshift(ri.cpu().numpy()), gram_rows(h.cpu().numpy()), atol=1e-5)


def test_sim_topk_fewer_targets_than_k(dev):
    h = torch.randn((1, 64, 5), device=dev)
    cid = torch.zeros(64, dtype=torch.int32, device=dev)
    cid[:2] = 1                                # rows 2.. see only 2 other-client nodes
    kv, ki = ops.sim_topk(h, cid, torch.ones((1, 64), device=dev), 4)
    assert (ki[0, 2:, 2:] == -1).all() and torch.isneginf(kv[0, 2:, 2:]).all()
    assert (ki[0, 2:, :2] >= 0).all()


def test_sim_topk_refuses_what_it_cannot_run(dev):
    h = torch.randn((1, 40, 17), device=dev)
    with pytest.raises(ValueError, match="c"):
        ops.sim_topk(h, torch.zeros(40, device=dev), torch.ones((1, 40), device=dev), 3)
    with pytest.raises(ValueError, match="k"):
        ops.sim_topk(h[..., :4], torch.zeros(40, device=dev),
                     torch.ones((1, 40), device=dev), 17)
