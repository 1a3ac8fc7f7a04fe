"""``flash_attention`` at a head dim without a kernel instance, on the CPU.

A head dim d up to the largest instance runs through the smallest instance
D >= d (``kernels.flash_attention.at_kernel_head_dim``, the helper both
``launch`` and ``launch_bwd`` go through): q, k, v, o and dO zero-padded to
D, the scale of the true d, the outputs cut back to d. Here the helper
drives the kernels' plain versions (``ref.flash_attention`` and
``ref.flash_attention_bwd``), and the padded and cut result is held to the
unpadded one within 1e-6 in f32, forward (with the row log-sum-exp) and
backward. The kernels themselves at such head dims are held on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref

TOL = 1e-6


def _inputs(b, hq, hkv, s, d, seed):
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, hq, s, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen) for _ in range(2))
    return q, k, v, do


def test_kernel_head_dim():
    """Every head dim from 1 to the largest instance maps to the smallest
    instance at or above it; an instance maps to itself; above it raises."""
    for d in range(1, kflash.HEAD_DIMS[-1] + 1):
        inst = kflash.kernel_head_dim(d)
        assert inst in kflash.HEAD_DIMS and inst >= d
        assert all(other < d for other in kflash.HEAD_DIMS if other < inst)
    assert kflash.kernel_head_dim(20) == 32 and kflash.kernel_head_dim(100) == 128
    for d in (0, 241, 256):
        with pytest.raises(ValueError, match="head dim"):
            kflash.kernel_head_dim(d)


@pytest.mark.parametrize("d", [20, 48, 100])
@pytest.mark.parametrize("b,hq,hkv,s,window", [(2, 5, 1, 40, None), (1, 4, 2, 70, 16)])
def test_padded_forward_equals_unpadded(d, b, hq, hkv, s, window):
    q, k, v, _ = _inputs(b, hq, hkv, s, d, seed=d + s)
    calls = []

    def plain(*args, **kw):
        calls.append((args[0].shape[-1], kw["scale"]))
        return ref.flash_attention(*args, **kw)

    got, lse = kflash.at_kernel_head_dim(plain, q, k, v, window=window, with_lse=True)
    want, want_lse = ref.flash_attention(q, k, v, window=window, with_lse=True)
    assert calls == [(kflash.kernel_head_dim(d), 1.0 / math.sqrt(d))]
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [20, 48, 100])
@pytest.mark.parametrize("b,hq,hkv,s,window", [(2, 5, 1, 40, None), (1, 4, 2, 70, 16)])
def test_padded_backward_equals_unpadded(d, b, hq, hkv, s, window):
    q, k, v, do = _inputs(b, hq, hkv, s, d, seed=2 * d + s)
    o, lse = ref.flash_attention(q, k, v, window=window, with_lse=True)
    got = kflash.at_kernel_head_dim(ref.flash_attention_bwd, q, k, v, o, do, lse,
                                    window=window)
    want = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=TOL, rtol=0, msg=name)


def test_padded_call_keeps_the_callers_scale():
    q, k, v, _ = _inputs(1, 2, 1, 30, 20, seed=3)
    got = kflash.at_kernel_head_dim(ref.flash_attention, q, k, v, scale=0.3)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, scale=0.3), atol=TOL, rtol=0)


def test_instances_and_mismatches_pass_through():
    """At an instance the call is made as it is; where the arguments
    disagree on the head dim nothing is padded, so the callee refuses them."""
    seen = []
    q, k, v, _ = _inputs(1, 2, 1, 8, 64, seed=4)
    kflash.at_kernel_head_dim(lambda *a, **kw: seen.append(a[0].shape[-1]), q, k, v)
    q20, k32 = q[..., :20], k[..., :32]
    kflash.at_kernel_head_dim(lambda *a, **kw: seen.append((a[0].shape[-1], a[1].shape[-1])),
                              q20, k32, k32)
    assert seen == [64, (20, 32)]


def test_launch_takes_the_card_only():
    """No fallback: a CPU tensor at a padded head dim reaches the kernel's
    device check, and a head dim above the largest instance raises."""
    q = torch.randn((1, 2, 16, 20))
    with pytest.raises(ValueError, match="CUDA"):
        kflash.launch(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        kflash.launch_bwd(q, q, q, q, q, torch.zeros((1, 2, 16)))
    q = torch.randn((1, 2, 16, 256))
    with pytest.raises(ValueError, match="head dim"):
        kflash.launch(q, q, q)
