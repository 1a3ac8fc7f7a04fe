"""The port's aggregation strategies and FedSage+ against the JAX package.

Partial participation, async (FedBuff) aggregation, single-host gossip and
FedSage+'s local generation: each aggregator on the same numpy-seeded
parameters and masks in both packages (1e-5 per op), the port's own
equivalences bit for bit (rho = 1 is the unmasked path; B = M with zero
delays is FedAvg), the async schedule against the reference's given the
reference's delay stream (exact), and a 3-round history of each new method
against a live reference run (1e-4), the reference's noise, masks and
delay stream handed to the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.core import registry as jreg
from repro.core import strategies as JS
from repro.core.partition import ring_adjacency
from repro_torch.checkpoint import io as pio
from repro_torch.core import gossip as pgossip
from repro_torch.core import registry as preg
from repro_torch.core import strategies as PS
from repro_torch.core.fedgl import FGLTrainer
from repro_torch.core.spreadfgl import make_spreadfgl_async
from repro_torch.launch import fgl_train
from torch_fgl_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_fgl_parity import (FIT_TOL, OP_TOL, assert_histories_close, fit_pair,
                              port_batch, port_state)


def _params(m, seed=0):
    """A toy [M]-stacked classifier tree, numpy, distinct per client."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((m, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((m, 3)).astype(np.float32)}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _agg_pair(j_agg, p_agg, n, m_per, adj, mask=None, round=0, seed=0):
    jp, pp = _both(_params(n * m_per, seed))
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    pmask = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    jo = j_agg.aggregate(jp, adj=jnp.asarray(adj), num_servers=n, m_per=m_per,
                         round=round, mask=jmask)
    po = p_agg.aggregate(pp, adj=torch.from_numpy(np.asarray(adj, np.float32)),
                         num_servers=n, m_per=m_per, round=round, mask=pmask)
    return {k: np.asarray(v) for k, v in jo.items()}, {k: v.numpy() for k, v in po.items()}


def _assert_trees(a, b, atol=OP_TOL):
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


def _bitwise(a, b):
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]).view(np.uint32),
                                      np.asarray(b[k]).view(np.uint32), err_msg=k)


AGGREGATORS = {
    "fedavg": (JS.FedAvgAggregator(), PS.FedAvgAggregator()),
    "neighbor": (JS.NeighborAggregator(), PS.NeighborAggregator()),
    "gossip_adjacency": (JS.GossipAggregator(topology="adjacency"),
                         PS.GossipAggregator(topology="adjacency")),
    "gossip_ring": (JS.GossipAggregator(topology="ring"),
                    PS.GossipAggregator(topology="ring")),
}


# ---------------------------------------------------------------------------
# Partial participation
# ---------------------------------------------------------------------------

class TestParticipation:
    @pytest.mark.parametrize("rho,want", [(0.5, 3), (0.25, 2), (0.1, 1), (1.0, 6)])
    def test_mask_shape_and_count(self, rho, want):
        mask = PS.participation_mask(PS.keyed_generator(0, 1), 6, rho)
        assert mask.shape == (6,) and mask.dtype == torch.float32
        assert float(mask.sum()) == want
        assert set(mask.unique().tolist()) <= {0.0, 1.0}

    def test_rejects_out_of_range_rho(self, small):
        batch, cfg = small
        for rho in (0.0, -0.5, 1.5):
            with pytest.raises(ValueError, match="participation"):
                PS.participation_mask(PS.keyed_generator(0), 6, rho)
            with pytest.raises(ValueError, match="participation"):
                FGLTrainer(cfg, batch, participation=rho, device="cpu")

    def test_mask_is_pure_function_of_seed_and_round(self, small):
        batch, cfg = small
        tr = preg.build("FedGL", cfg, batch, participation=0.5, device="cpu")
        assert tr.cfg.participation == tr.participation == 0.5
        torch.testing.assert_close(tr._participation_mask(3), tr._participation_mask(3),
                                   rtol=0, atol=0)
        masks = [tr._participation_mask(t) for t in range(8)]
        assert any(not torch.equal(masks[0], m) for m in masks[1:])
        assert all(m.shape == (batch.num_clients,) and m.sum() == 2 for m in masks)
        other = preg.build("FedGL", dataclasses.replace(cfg, seed=1), batch,
                           participation=0.5, device="cpu")
        assert any(not torch.equal(masks[t], other._participation_mask(t)) for t in range(8))

    @pytest.mark.parametrize("name", sorted(AGGREGATORS))
    @pytest.mark.parametrize("mask", [[1, 0, 1, 0, 0, 1], [0, 0, 0, 1, 1, 0],
                                      [1, 1, 1, 1, 1, 1]],
                             ids=["partial", "server0_out", "all_in"])
    def test_masked_aggregator_matches_reference(self, name, mask):
        n, m_per = (3, 2) if name == "gossip_ring" else (2, 3)
        adj = ring_adjacency(n)
        j_agg, p_agg = AGGREGATORS[name]
        jo, po = _agg_pair(j_agg, p_agg, n, m_per, adj, mask=mask)
        _assert_trees(jo, po)

    @pytest.mark.parametrize("name", ["fedavg", "neighbor", "gossip_adjacency"])
    def test_all_ones_mask_matches_unmasked(self, name):
        agg = AGGREGATORS[name][1]
        _, pp = _both(_params(6, 1))
        kw = dict(adj=torch.ones(2, 2), num_servers=2, m_per=3)
        _bitwise(agg.aggregate(pp, **kw), agg.aggregate(pp, mask=torch.ones(6), **kw))

    def test_all_out_server_falls_back_to_plain_mean(self):
        p = _params(6, 2)
        _, pp = _both(p)
        out = PS.FedAvgAggregator().aggregate(pp, adj=torch.ones(2, 2), num_servers=2,
                                              m_per=3, mask=torch.tensor([0., 0, 0, 1, 1, 0]))
        np.testing.assert_allclose(out["w"][0].numpy(), p["w"][:3].mean(0), rtol=1e-6)
        np.testing.assert_allclose(out["w"][3].numpy(), (p["w"][3] + p["w"][4]) / 2,
                                   rtol=1e-6)

    def test_neighbor_matches_hand_computed_eq16(self):
        """Eq. 16 with M_r replaced by the participating count."""
        p = _params(6, 3)
        _, pp = _both(p)
        a = ring_adjacency(2)
        mask = torch.tensor([1., 1, 0, 1, 0, 0])
        out = PS.NeighborAggregator().aggregate(pp, adj=torch.from_numpy(a), num_servers=2,
                                                m_per=3, mask=mask)
        csum, counts = np.stack([p["w"][0] + p["w"][1], p["w"][3]]), np.array([2.0, 1.0])
        for j in range(2):
            want = sum(a[r, j] * csum[r] for r in range(2)) / sum(a[r, j] * counts[r]
                                                                  for r in range(2))
            np.testing.assert_allclose(out["w"][j * 3].numpy(), want, rtol=1e-6)

    def test_identity_ignores_mask(self):
        _, pp = _both(_params(6))
        out = PS.IdentityAggregator().aggregate(pp, adj=None, num_servers=2, m_per=3,
                                                mask=torch.tensor([1., 0, 0, 0, 0, 0]))
        assert out is pp

    def test_rho_one_is_the_unmasked_path_bit_for_bit(self, small):
        batch, cfg = small
        tr_def = preg.build("SpreadFGL", cfg, batch, num_servers=2, device="cpu")
        tr_one = preg.build("SpreadFGL", dataclasses.replace(cfg, participation=1.0),
                            batch, num_servers=2, device="cpu")
        assert tr_one._participation_mask(0) is None
        (_, h_def), (_, h_one) = (tr.fit(port_batch(batch), rounds=3)
                                  for tr in (tr_def, tr_one))
        h_def.pop("seconds"), h_one.pop("seconds")
        assert h_def == h_one

    def test_history_matches_reference(self, small):
        batch, cfg = small
        jtr = jreg.build("SpreadFGL", cfg, batch, num_servers=2, participation=0.5)
        ptr = preg.build("SpreadFGL", cfg, batch, num_servers=2, participation=0.5,
                         device="cpu")
        jh, ph, _ = fit_pair(jtr, ptr, jtr.init(jax.random.key(0), batch), 3)
        assert_histories_close(ph, jh)


# ---------------------------------------------------------------------------
# Async (FedBuff) aggregation
# ---------------------------------------------------------------------------

class TestAsync:
    def test_stream_zero_branch(self):
        delays, drops = PS.async_delay_stream(0, 3, 8)
        np.testing.assert_array_equal(delays, np.zeros(8, np.int32))
        assert delays.dtype == np.int32 and not drops.any()

    @pytest.mark.parametrize("dist", ("uniform", "geometric"))
    def test_stream_bounds_and_reproducibility(self, dist):
        draws = [PS.async_delay_stream(1, t, 32, delay_dist=dist, max_delay=3,
                                       dropout_rate=0.3) for t in range(10)]
        for delays, drops in draws:
            assert delays.min() >= 0 and delays.max() <= 3 and drops.dtype == bool
        again = PS.async_delay_stream(1, 4, 32, delay_dist=dist, max_delay=3,
                                      dropout_rate=0.3)
        np.testing.assert_array_equal(again[0], draws[4][0])
        np.testing.assert_array_equal(again[1], draws[4][1])
        assert any(np.any(draws[0][0] != d[0]) for d in draws[1:])
        # The drops do not depend on the delay distribution.
        np.testing.assert_array_equal(
            PS.async_delay_stream(1, 4, 32, dropout_rate=0.3)[1], draws[4][1])

    def test_geometric_mass_at_zero(self):
        d = np.concatenate([PS.async_delay_stream(0, t, 64, delay_dist="geometric")[0]
                            for t in range(16)])
        assert 0.35 < (d == 0).mean() < 0.65

    def test_validation(self):
        with pytest.raises(ValueError, match="delay_dist"):
            PS.async_delay_stream(0, 0, 4, delay_dist="pareto")
        with pytest.raises(ValueError, match="max_delay"):
            PS.async_delay_stream(0, 0, 4, max_delay=-1)
        with pytest.raises(ValueError, match="dropout_rate"):
            PS.async_delay_stream(0, 0, 4, dropout_rate=1.0)
        with pytest.raises(ValueError, match="buffer_size"):
            PS.AsyncAggregator(buffer_size=0)
        with pytest.raises(ValueError, match="never fill"):
            PS.AsyncAggregator(buffer_size=9).phase(0, 4)

    @pytest.mark.parametrize("dist,drop", [("zero", 0.0), ("uniform", 0.1),
                                           ("geometric", 0.2)])
    def test_schedule_matches_reference_given_its_stream(self, dist, drop):
        spec = (11, 5, 3, dist, 4, drop)
        for t in range(24):
            jf, jw = JS._async_schedule(spec, t)
            pf, pw = PS._async_schedule(spec, t, stream=JS.async_delay_stream)
            assert pf == jf, t
            assert (pw is None) == (jw is None), t
            if jw is not None:
                np.testing.assert_array_equal(pw, jw)
        # The port's own stream is cached apart from the reference's.
        assert (spec, JS.async_delay_stream) in PS._ASYNC_SCHEDULES
        assert (spec, PS.async_delay_stream) not in PS._ASYNC_SCHEDULES

    def test_weights_are_staleness_discounts(self):
        agg = PS.AsyncAggregator(buffer_size=2, delay_dist="geometric",
                                 dropout_rate=0.3, seed=5)
        seen = set()
        for t in range(30):
            w = agg.round_weights(t, 6)
            if w is None:
                continue
            for wi in w[w > 0].numpy():
                tau = 1.0 / np.float32(wi) ** 2 - 1.0
                assert abs(tau - round(float(tau))) < 1e-5
                seen.add(int(round(float(tau))))
        assert 0 in seen and max(seen) >= 1

    def test_flush_matches_reference(self):
        w = [1.0, 0.5, 0.0, 0.0]
        jo, po = _agg_pair(JS.AsyncAggregator(buffer_size=2), PS.AsyncAggregator(buffer_size=2),
                           2, 2, np.eye(2, dtype=np.float32), mask=w, round=1)
        _assert_trees(jo, po)
        p = _params(4)
        np.testing.assert_array_equal(po["w"][2:], p["w"][2:])   # nothing buffered

    def test_unit_weights_are_fedavg_bit_for_bit(self):
        _, pp = _both(_params(4, 4))
        kw = dict(adj=torch.eye(2), num_servers=2, m_per=2)
        _bitwise(PS.FedAvgAggregator().aggregate(pp, **kw),
                 PS.AsyncAggregator(buffer_size=4).aggregate(pp, round=1,
                                                             mask=torch.ones(4), **kw))
        assert PS.AsyncAggregator(buffer_size=4).aggregate(pp, round=0, **kw) is pp

    def test_b_equals_m_is_fedavg_bit_for_bit(self, small):
        batch, cfg = small
        m, pb = batch.num_clients, port_batch(batch)
        _, h_sync = preg.build("FedGL", cfg, batch, device="cpu").fit(pb, rounds=3)
        tr = preg.build("spreadfgl_async", dataclasses.replace(cfg, async_buffer=m),
                        batch, num_servers=1, device="cpu")
        assert isinstance(tr.topology, PS.StarTopology)
        _, h_async = tr.fit(pb, rounds=3)
        for h in (h_sync, h_async):
            h.pop("seconds")
        assert h_async == h_sync

    def test_agg_mask_multiplies_participation_into_weights(self, small):
        batch, cfg = small
        cfg = dataclasses.replace(cfg, async_buffer=batch.num_clients, participation=0.5)
        tr = make_spreadfgl_async(cfg, batch, num_servers=1, device="cpu")
        torch.testing.assert_close(tr._agg_mask(0), tr._participation_mask(0),
                                   rtol=0, atol=0)      # unit weights at B = M

    def test_resume_mid_buffer_bit_for_bit(self, small, tmp_path):
        batch, cfg = small
        cfg = dataclasses.replace(cfg, imputation_interval=2, async_buffer=2,
                                  delay_dist="geometric", dropout_rate=0.2,
                                  participation=0.5)
        tr = make_spreadfgl_async(cfg, batch, num_servers=2, device="cpu")
        pb = port_batch(batch)
        _, full = tr.fit(pb, rounds=5)
        state, first = tr.fit(pb, rounds=2)
        pio.save(tmp_path / "a.npz", state)
        PS._ASYNC_SCHEDULES.clear()     # resume must not lean on the warm cache
        restored = fgl_train.resume_state(tmp_path / "a.npz", tr.init(pb))
        assert restored.round == 2
        _, second = tr.fit(state=restored, rounds=3)
        for k in ("round", "loss", "acc", "f1"):
            assert first[k] + second[k] == full[k], k

    def test_history_matches_reference(self, small, monkeypatch):
        batch, cfg = small
        cfg = dataclasses.replace(cfg, async_buffer=2, delay_dist="uniform",
                                  dropout_rate=0.1)
        jtr = jreg.build("spreadfgl_async", cfg, batch, num_servers=2)
        ptr = preg.build("spreadfgl_async", cfg, batch, num_servers=2, device="cpu")
        monkeypatch.setattr(PS, "async_delay_stream", JS.async_delay_stream)
        flushes = [ptr._agg_phase(t) for t in range(3)]
        assert flushes == [jtr._agg_phase(t) for t in range(3)] and 0 in flushes
        jh, ph, _ = fit_pair(jtr, ptr, jtr.init(jax.random.key(0), batch), 3)
        assert_histories_close(ph, jh)


# ---------------------------------------------------------------------------
# Gossip on one host
# ---------------------------------------------------------------------------

class TestGossip:
    @pytest.mark.parametrize("n,m_per", [(2, 2), (4, 2), (8, 1)])
    def test_k1_equals_eq16(self, n, m_per):
        _, pp = _both(_params(n * m_per, 5))
        kw = dict(adj=torch.from_numpy(ring_adjacency(n)), num_servers=n, m_per=m_per)
        dense = PS.NeighborAggregator().aggregate(pp, **kw)
        gossiped = PS.GossipAggregator().aggregate(pp, **kw)
        _assert_trees({k: v.numpy() for k, v in dense.items()},
                      {k: v.numpy() for k, v in gossiped.items()}, atol=1e-6)

    @pytest.mark.parametrize("topology,n", [("ring", 4), ("ring", 2), ("adjacency", 4)])
    @pytest.mark.parametrize("phase", [0, 1, 2, 3])
    def test_matches_reference_on_and_off_schedule(self, topology, n, phase):
        jo, po = _agg_pair(JS.GossipAggregator(topology=topology, every_k=4),
                           PS.GossipAggregator(topology=topology, every_k=4),
                           n, 2, ring_adjacency(n), round=phase)
        _assert_trees(jo, po)

    def test_skip_rounds_are_per_server_fedavg(self):
        _, pp = _both(_params(8, 6))
        kw = dict(adj=torch.from_numpy(ring_adjacency(4)), num_servers=4, m_per=2)
        fedavg = PS.FedAvgAggregator().aggregate(pp, **kw)
        agg = PS.GossipAggregator(every_k=4)
        for phase in (0, 1, 2):
            _bitwise({k: v.numpy() for k, v in fedavg.items()},
                     {k: v.numpy() for k, v in agg.aggregate(pp, round=phase, **kw).items()})
        assert not torch.allclose(agg.aggregate(pp, round=3, **kw)["w"], fedavg["w"])

    @pytest.mark.parametrize("n", [3, 5, 8])
    def test_ring_route_equals_adjacency_route(self, n):
        w = {"w": torch.from_numpy(_params(n)["w"])}
        torch.testing.assert_close(pgossip.block_ring_gossip(w)["w"],
                                   pgossip.adjacency_gossip(w, torch.from_numpy(
                                       ring_adjacency(n)))["w"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pgossip.block_ring_gossip(w)["w"].numpy(),
                                   np.asarray(jgossip.block_ring_gossip(
                                       {"w": jnp.asarray(w["w"].numpy())})["w"]),
                                   atol=OP_TOL)

    def test_byte_accounting_matches_reference(self):
        adj = ring_adjacency(5)
        for fn, args, kw in ((pgossip.ring_gossip_bytes_per_round, (1000,), {"every": 3}),
                             (pgossip.dense_neighbor_bytes_per_round, (adj, 1000), {"every": 2}),
                             (pgossip.allreduce_bytes_per_round, (1000, 5), {}),
                             (pgossip.gossip_allreduce_ratio, (1600.0, 2000.0), {"every": 4})):
            assert fn(*args, **kw) == getattr(jgossip, fn.__name__)(*args, **kw)

    def test_validation_and_mesh(self):
        with pytest.raises(ValueError, match="topology"):
            PS.GossipAggregator(topology="mesh")
        with pytest.raises(ValueError, match="every_k"):
            PS.GossipAggregator(every_k=0)
        from repro_torch.launch import mesh
        one = mesh.make_edge_mesh(3)           # no process group: size 1
        assert PS.GossipAggregator(mesh=one).mesh.size == 1

    def test_builder_takes_every_k_from_cfg(self, small):
        batch, cfg = small
        tr = preg.build("spreadfgl_gossip", dataclasses.replace(cfg, gossip_every=5),
                        batch, num_servers=2, device="cpu")
        assert tr.aggregator.every_k == tr._agg_period == 5
        assert [tr._agg_phase(t) for t in range(5)] == [0, 0, 0, 0, 4]

    def test_history_matches_reference(self, small):
        """K = 2 on a 4-server ring (the ring route), 3 rounds."""
        batch, cfg = small
        jtr = jreg.build("spreadfgl_gossip", cfg, batch, num_servers=4, gossip_every=2)
        ptr = preg.build("spreadfgl_gossip", cfg, batch, num_servers=4, gossip_every=2,
                         device="cpu")
        jh, ph, _ = fit_pair(jtr, ptr, jtr.init(jax.random.key(0), batch), 3)
        assert_histories_close(ph, jh)


# ---------------------------------------------------------------------------
# FedSage+
# ---------------------------------------------------------------------------

class TestFedSagePlus:
    @pytest.fixture(scope="class")
    def pair(self, small):
        batch, cfg = small
        jtr = jreg.build("fedsage_plus", cfg, batch)
        ptr = preg.build("fedsage_plus", cfg, batch, device="cpu")
        return jtr, ptr, jtr.init(jax.random.key(0), batch)

    def test_imputation_round_matches_reference(self, pair):
        jtr, ptr, jstate = pair
        batch = jstate.batch
        n_local, aug = batch.n_local_max, batch.aug_max
        # Degrees tie: the aug_max-th highest degree is shared by more nodes
        # than the slots left for it, so the tie order decides the sources.
        deg = np.asarray(jnp.sum(batch.adj[:, :n_local, :n_local], -1))
        kth = -np.sort(-deg, axis=-1)[:, aug - 1]
        assert any((deg[i] == kth[i]).sum() > (-np.sort(-deg[i]) == kth[i])[:aug].sum()
                   for i in range(batch.num_clients))
        jnext = jtr._impute_fn(jstate)
        ps = port_state(jstate)
        gen_before = ps.gen.get_state().clone()
        before = {f: getattr(ps.batch, f).clone() for f in ("x", "adj", "node_mask")}
        pnext = ptr.imputation.impute(ptr, ps)
        for f in ("adj", "node_mask"):
            np.testing.assert_array_equal(getattr(pnext.batch, f).numpy(),
                                          np.asarray(getattr(jnext.batch, f)), err_msg=f)
        np.testing.assert_allclose(pnext.batch.x.numpy(), np.asarray(jnext.batch.x),
                                   atol=FIT_TOL)
        # No randomness drawn, and the caller's batch is untouched.
        assert torch.equal(ps.gen.get_state(), gen_before)
        for f, t in before.items():
            assert torch.equal(getattr(ps.batch, f), t), f

    def test_history_matches_reference(self, pair):
        jtr, ptr, jstate = pair
        jh, ph, _ = fit_pair(jtr, ptr, jstate, 3)
        assert_histories_close(ph, jh)


def test_registry_has_every_reference_method():
    assert preg.names() == jreg.names()
