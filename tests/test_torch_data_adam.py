"""The port's data path and Adam against the JAX package.

The synthetic graphs and all four partitioners are numpy copies of the
reference, so their arrays must agree bit for bit (exact equality, in both
edge-sampler regimes). Adam repeats the reference's order of operations;
five steps agree within 1e-5 (f32 per op; XLA and torch may round the
``b1**t`` power differently in the last ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.data import synthetic_graphs as jdata
from repro.optim.adam import Adam as JAdam
from repro_torch.core import partition as ppart
from repro_torch.data import synthetic_graphs as pdata
from repro_torch.optim.adam import Adam as PAdam
from repro_torch.tree import tree_map

BATCH_FIELDS = ("x", "adj", "y", "node_mask", "train_mask", "test_mask", "global_id")


def _same_graph(gp, gj):
    for f in ("x", "senders", "receivers", "y"):
        a, b = np.asarray(getattr(gp, f)), np.asarray(getattr(gj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert gp.num_classes == gj.num_classes


class TestSyntheticGraphs:
    @pytest.mark.parametrize("name,scale", [
        ("cora", 0.1),          # per-edge loop sampler (scale <= 1)
        ("citeseer", 0.05),
        ("wikics", 0.02),
        ("cora", 1.5),          # vectorized sampler (scale > 1)
    ])
    def test_bit_identical(self, name, scale):
        kw = dict(scale=scale, seed=3, feature_noise=3.0, signal_ratio=0.5)
        _same_graph(pdata.make_sbm_graph(pdata.DATASETS[name], **kw),
                    jdata.make_sbm_graph(jdata.DATASETS[name], **kw))

    def test_dataset_table_matches(self):
        assert {k: dataclasses.astuple(v) for k, v in pdata.DATASETS.items()} == \
               {k: dataclasses.astuple(v) for k, v in jdata.DATASETS.items()}


class TestPartitioners:
    @pytest.mark.parametrize("name,kw", [
        ("label_prop", {}),
        ("dirichlet", {"alpha": 0.3}),
        ("degree", {}),
        ("random", {}),
    ])
    def test_bit_identical(self, sbm_graph_small, name, kw):
        g = sbm_graph_small
        pg = pdata.make_sbm_graph(pdata.DATASETS["cora"], scale=0.10, seed=1,
                                  feature_noise=3.0, signal_ratio=0.5)
        _same_graph(pg, g)
        bj, aj = jpart.partition_graph(g, 5, aug_max=6, seed=2, label_ratio=0.3,
                                       partitioner=jpart.make_partitioner(name, **kw))
        bp, ap = ppart.partition_graph(pg, 5, aug_max=6, seed=2, label_ratio=0.3,
                                       partitioner=ppart.make_partitioner(name, **kw))
        np.testing.assert_array_equal(ap, aj)
        for f in BATCH_FIELDS:
            a, b = np.asarray(getattr(bp, f)), np.asarray(getattr(bj, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert (bp.num_classes, bp.aug_max) == (bj.num_classes, bj.aug_max)
        assert ppart.count_missing_links(pg, ap) == jpart.count_missing_links(g, aj)
        np.testing.assert_array_equal(ppart.label_skew_entropy(ap, pg.y, 5),
                                      jpart.label_skew_entropy(aj, g.y, 5))

    def test_batch_to_device_keeps_dtypes(self, small_batch):
        pg = pdata.make_sbm_graph(pdata.DATASETS["cora"], scale=0.10, seed=1,
                                  feature_noise=3.0, signal_ratio=0.5)
        bp, _ = ppart.partition_graph(pg, 4, aug_max=8, seed=0, label_ratio=0.3)
        t = bp.to("cpu")
        assert t.x.dtype == torch.float32 and t.y.dtype == torch.int32
        assert t.global_id.dtype == torch.int32
        np.testing.assert_array_equal(t.adj.numpy(), np.asarray(small_batch.adj))


def _tree(rng, lead=()):
    return {"layers": [{"w": rng.normal(size=lead + (5, 3)).astype(np.float32),
                        "b": rng.normal(size=lead + (3,)).astype(np.float32)},
                       {"w": rng.normal(size=lead + (3, 2)).astype(np.float32)}]}


class TestAdam:
    @pytest.mark.parametrize("lead", [(), (3,)])   # scalar step; stacked [N] step
    def test_five_steps_match(self, lead):
        rng = np.random.default_rng(0)
        params = _tree(rng, lead)
        grads = [_tree(rng, lead) for _ in range(5)]
        jopt, popt = JAdam(lr=0.01), PAdam(lr=0.01)
        jp = jax.tree.map(jnp.asarray, params)
        pp = tree_map(torch.from_numpy, params)
        if lead:
            js = jax.vmap(jopt.init)(jp)
            jupd = jax.vmap(jopt.update)
        else:
            js, jupd = jopt.init(jp), jopt.update
        ps = popt.init(pp, lead=lead)
        for g in grads:
            jp, js = jupd(jax.tree.map(jnp.asarray, g), js, jp)
            pp, ps = popt.update(tree_map(torch.from_numpy, g), ps, pp)
        np.testing.assert_array_equal(ps.step.numpy(), np.asarray(js.step))
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, (jp, js.mu, js.nu))),
                        jax.tree.leaves(tree_map(lambda t: t.numpy(), (pp, ps.mu, ps.nu)))):
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-6)
