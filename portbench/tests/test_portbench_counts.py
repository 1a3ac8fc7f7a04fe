"""The benchmark's counts of work, against values worked by hand."""
import pytest

from portbench import counts

# 10 real rows, 6 nonzeros, widths d=4 -> h=3 -> c=2, T_l = 2; AE hidden 2,
# assessor {2,3,1}; one AE step and one assessor step, one outer iteration.
S = counts.Shapes(rows=10, nnz=6, dims=[4, 3, 2], local_rounds=2, ae_hidden=2,
                  assessor_hidden=[3], ae_iters=1, assessor_iters=1, ae_outer_iters=1,
                  cross_pairs=7)


def test_classifier_forward_backward():
    # forward: layer 1 2*2*10*4*3 = 480; layer 2 2*2*10*3*2 = 240 + mean 2*6*3 = 36
    assert counts.classifier_forward(S) == 480 + 240 + 36
    # backward: weight grads 480 + 240; layer 2's input grads 240 + 36
    assert counts.classifier_backward(S) == 480 + 240 + 240 + 36
    assert counts.layer1_mean(S) == 2 * 6 * 4


def test_generator_and_gram():
    # AE per row: enc 2*(2*2 + 2*4) = 24, dec 2*(4*2 + 2*2) = 24, fwd 48;
    # bwd = 48 + (2*2*4 + 24) = 88. Assessor {2,3,1}: fwd 2*(2*3 + 3*1) = 18,
    # inner input grads 18 - 12 = 6. AE step 48 + 18 + 18 + 88 = 172;
    # assessor step 2*18 + 2*18 + 2*6 = 84; + reconstruction 48 + X̅ 24.
    assert counts.generator(S) == 10 * (172 + 84 + 48 + 24)
    assert counts.gram(S) == 2 * 2 * 7


@pytest.mark.parametrize("impute,extra", [(False, 0), (True, 756 + 3280 + 28)])
def test_round(impute, extra):
    base = 2 * (756 + 996) + 756 + 48
    assert counts.round_flops(S, impute) == base + extra


def test_kernel_bytes_and_ops():
    # 6 nonzeros x 8 B, 5 referenced rows x 4 features x 4 B, 12 output rows.
    assert counts.sage_bytes(6, 5, 4, 12) == 48 + 80 + 192
    assert counts.sim_topk_ops(7, 2) == 28
    # 10 valid rows x 2 x 4 B read, 12 rows x 3 (score, index) pairs written.
    assert counts.sim_topk_bytes(10, 2, 12, 3) == 80 + 288
