"""The port's distributed edge layer on ``gloo`` groups on the CPU.

Ranks are started by ``repro_torch.launch.mesh.spawn`` (bodies in
``tests/torch_mesh_workers.py``), three groups in all, each running several
cases, and the results are held against the JAX package's single-device
paths in this process (its own multi-device runs drift under jax 0.9,
ROADMAP §3):

- The gossip collectives (``ring_gossip``, ``all_average``, ``maybe_gossip``
  and the mesh forms of ``block_ring_gossip`` / ``adjacency_gossip``) on 2
  and 4 ranks, against the reference's ``block_ring_gossip(w)`` /
  ``adjacency_gossip(w, adj)`` with ``axis=None`` on the stacked array, 1e-6;
  the mean over ranks is kept.
- SpreadFGL, FedGL and ``spreadfgl_gossip`` with ``edge_mesh=`` and
  ``sim_mesh=`` on 2 ranks, against the reference's single-device ``fit``
  from the same state with the same noise: 1e-4 a round; the link
  proposals of the first imputation round under the tie rule
  (``torch_parity.assert_topk_match``). The same runs through
  ``fgl_train --edge-mesh --sim-shard`` and ``edge_mesh --devices 2``,
  within 1e-4 of the same launcher in one process.
- Spread LM training, 3 steps of the qwen3-4b smoke config on 2 pods,
  against the reference's per-pod step followed by its
  ``block_ring_gossip`` over the stacked pods: losses and parameters 1e-4.
"""
import concurrent.futures
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import gossip as jgossip
from repro.core import registry as jreg
from repro.data.lm_data import token_batches
from repro.models import transformer as jtr
from repro.optim import adam as jadam
from repro.train import step as jstep
from repro_torch.launch import edge_mesh
from repro_torch.launch import fgl_train
from repro_torch.launch import mesh as mesh_lib
from torch_fgl_parity import (FIT_TOL, assert_histories_close, port_batch, port_state,
                              replay_noises)
from torch_mesh_workers import portable_config, sleep_for, world_cases
from torch_parity import assert_topk_match, gram_rows

ROUNDS = 2
EVERY = 2
# (name, method, builder keywords, mesh flags): the edge mesh, the sim mesh,
# one mesh for both; FedGL's one server; gossip over 4 servers (2 a rank,
# the ring's boundary exchange) and over 2 (the adjacency path).
RUNS = [("spread_edge", "SpreadFGL", {"num_servers": 2}, ("edge",)),
        ("spread_sim", "SpreadFGL", {"num_servers": 2}, ("sim",)),
        ("spread_both", "SpreadFGL", {"num_servers": 2}, ("edge", "sim")),
        ("fedgl_sim", "FedGL", {}, ("sim",)),
        ("gossip_ring", "spreadfgl_gossip", {"num_servers": 4, "gossip_every": EVERY},
         ("edge", "sim")),
        ("gossip_adjacency", "spreadfgl_gossip", {"num_servers": 2, "gossip_every": EVERY},
         ("edge",))]
CLI = ["--device", "cpu", "--dataset", "cora", "--scale", "0.06", "--clients", "4",
       "--rounds", "2", "--local-rounds", "1", "-K", "1", "--top-k", "3"]
CLIS = [CLI + ["--servers", "2", "--edge-mesh", "--sim-shard"],
        CLI + ["--servers", "4", "--gossip-every", "2", "--edge-mesh"]]
LM_ARCH, LM_STEPS, LM_BATCH = "qwen3-4b", 3, 4


def _gossip_inputs(size):
    rng = np.random.default_rng(size)
    per_rank = {"w": rng.standard_normal((size, 3, 4)).astype(np.float32),
                "b": rng.standard_normal((size, 5)).astype(np.float32)}
    n = 2 * size
    stacked = {"w": rng.standard_normal((n, 3, 2)).astype(np.float32),
               "b": rng.standard_normal((n, 7)).astype(np.float32)}
    adj = (rng.random((n, n)) + 0.1).astype(np.float32)
    return per_rank, stacked, adj


def _lm_inputs():
    """The reference's weights and token batches."""
    jcfg = jconfigs.get_config(LM_ARCH, "smoke")
    params = jax.jit(jtr.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    it = token_batches(jcfg, batch=LM_BATCH, seq_len=40, seed=1)
    return params, [next(it) for _ in range(LM_STEPS)]


def _lm_reference(params, batches):
    """The reference's 2-pod run: each pod its own step on its rows, the
    stacked pods' ``block_ring_gossip`` every ``EVERY`` steps. Returns
    (per-pod losses, per-pod final params)."""
    jcfg = jconfigs.get_config(LM_ARCH, "smoke")
    opt = jadam.Adam(lr=3e-4, clip_norm=1.0, schedule=jadam.cosine_schedule(1, LM_STEPS))
    fn = jax.jit(jstep.make_train_step(jcfg, opt))
    states = [jstep.TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32)) for _ in range(2)]
    losses = [[], []]
    rows = LM_BATCH // 2
    for i, batch in enumerate(batches):
        for p in range(2):
            mine = {k: jnp.asarray(v[p * rows:(p + 1) * rows]) for k, v in batch.items()}
            states[p], metrics = fn(states[p], mine)
            losses[p].append(float(metrics["loss"]))
        if (i + 1) % EVERY == 0:
            mixed = jgossip.block_ring_gossip(
                jax.tree.map(lambda *x: jnp.stack(x), *[s.params for s in states]))
            states = [s._replace(params=jax.tree.map(lambda x, p=p: x[p], mixed))
                      for p, s in enumerate(states)]
    return losses, [jax.tree.map(np.asarray, s.params) for s in states]


@pytest.fixture(scope="module")
def world2(small):
    """Everything on 2 ranks in one start: gossip, the FGL runs and the CLI,
    spread training. The reference's runs go on in this process while the
    ranks run. Returns (reference side, every rank's results)."""
    batch, cfg = small
    runs, layouts = [], {}
    for name, method, kw, flags in RUNS:
        key = (method, tuple(sorted(kw.items())))     # one reference run per layout
        if key not in layouts:
            jt = jreg.build(method, cfg, batch, **kw)
            js = jt.init(jax.random.key(0), batch)
            layouts[key] = (jt, js, replay_noises(jt, js, ROUNDS))
        jt, js, noises = layouts[key]
        runs.append((name, method, kw, flags,
                     dataclasses.replace(port_state(js), gen=None), noises))
    params, batches = _lm_inputs()
    params = jax.tree.map(np.asarray, params)
    gossip_in = _gossip_inputs(2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mesh_lib.spawn, world_cases, 2, "cpu", kwargs={
            "gossip_args": gossip_in,
            "fgl_args": (port_batch(batch), portable_config(cfg), runs, ROUNDS, CLIS),
            "spread_args": (params, LM_ARCH, batches, EVERY)})
        refs = {}
        for key, (jt, js, _) in layouts.items():
            (_, _, _, _, s, i, x), _ = jt.imputation.server_outputs(jt, js)
            _, jh = jt.fit(state=js, rounds=ROUNDS)
            emb = np.asarray(jt._embeddings(js.params, js.batch))
            refs[key] = {"hist": jh, "scores": np.asarray(s), "idx": np.asarray(i),
                         "x_bar": np.asarray(x),
                         "h": emb.reshape(jt.n_servers, -1, emb.shape[-1])}
        lm_losses, lm_params = _lm_reference(params, batches)
        ranks = ranks.result()
    fgl = {name: refs[(method, tuple(sorted(kw.items())))] for name, method, kw, _ in RUNS}
    ref = {"gossip": gossip_in, "fgl": fgl, "lm_losses": lm_losses, "lm_params": lm_params}
    return ref, ranks


@pytest.fixture(scope="module")
def world4():
    gossip_in = _gossip_inputs(4)
    return gossip_in, mesh_lib.spawn(world_cases, 4, "cpu",
                                     kwargs={"gossip_args": gossip_in})


@pytest.fixture(params=[2, 4])
def gossip_world(request):
    """(per_rank, stacked, adj) and every rank's gossip results."""
    if request.param == 2:
        ref, ranks = request.getfixturevalue("world2")
        return ref["gossip"], [r["gossip"] for r in ranks]
    gossip_in, ranks = request.getfixturevalue("world4")
    return gossip_in, [r["gossip"] for r in ranks]


# -- gossip collectives --------------------------------------------------------

def test_ring_gossip_is_the_references_ring(gossip_world):
    (per_rank, _, _), ranks = gossip_world
    want = jgossip.block_ring_gossip({k: jnp.asarray(v) for k, v in per_rank.items()})
    for r, got in enumerate(ranks):
        assert got["rank"] == r and got["size"] == len(ranks)
        for k in per_rank:
            np.testing.assert_allclose(got["ring"][k], np.asarray(want[k])[r], atol=1e-6,
                                       rtol=0)


def test_ring_gossip_keeps_the_mean(gossip_world):
    (per_rank, _, _), ranks = gossip_world
    for k, v in per_rank.items():
        mixed = np.stack([got["ring"][k] for got in ranks])
        np.testing.assert_allclose(mixed.mean(0), v.mean(0), atol=1e-6, rtol=0)


def test_all_average_and_maybe_gossip(gossip_world):
    (per_rank, _, _), ranks = gossip_world
    size = len(ranks)
    mean = jgossip.adjacency_gossip({k: jnp.asarray(v) for k, v in per_rank.items()},
                                    jnp.ones((size, size)))
    for r, got in enumerate(ranks):
        for k, v in per_rank.items():
            np.testing.assert_allclose(got["all_average"][k], np.asarray(mean[k])[r],
                                       atol=1e-6, rtol=0)
            np.testing.assert_array_equal(got["maybe_skip"][k], v[r])     # step 0 of K = 2
            np.testing.assert_array_equal(got["maybe_do"][k], got["ring"][k])


def test_block_ring_gossip_over_blocks(gossip_world):
    (_, stacked, _), ranks = gossip_world
    assert all(got["edge_size"] == len(ranks) for got in ranks)
    want = jgossip.block_ring_gossip({k: jnp.asarray(v) for k, v in stacked.items()})
    for k in stacked:
        got = np.concatenate([r["block_ring"][k] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(want[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.mean(0), stacked[k].mean(0), atol=1e-6, rtol=0)


def test_adjacency_gossip_over_blocks(gossip_world):
    (_, stacked, adj), ranks = gossip_world
    want = jgossip.adjacency_gossip({k: jnp.asarray(v) for k, v in stacked.items()},
                                    jnp.asarray(adj))
    for k in stacked:
        got = np.concatenate([r["adjacency"][k] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(want[k]), atol=1e-6, rtol=0)


# -- the FGL engine on the edge and sim meshes -----------------------------------

@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_fgl_history_matches_single_device_reference(world2, name):
    ref, ranks = world2
    for got in ranks:              # every rank ends each round with the same state
        assert_histories_close(got["fgl"][name]["hist"], ref["fgl"][name]["hist"], FIT_TOL)
    for key in ("loss", "acc", "f1"):
        assert ranks[0]["fgl"][name]["hist"][key] == ranks[1]["fgl"][name]["hist"][key]


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_fgl_link_proposals_match_reference(world2, name):
    ref, ranks = world2
    want, got = ref["fgl"][name], ranks[0]["fgl"][name]
    assert_topk_match(got["scores"], got["idx"], want["scores"], want["idx"],
                      gram_rows(want["h"]), atol=FIT_TOL)
    np.testing.assert_allclose(got["x_bar"], want["x_bar"], atol=FIT_TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["fgl"][name]["idx"], got["idx"])


@pytest.mark.parametrize("which", range(len(CLIS)))
def test_fgl_train_on_two_ranks_matches_one_process(world2, which):
    _, ranks = world2
    alone = fgl_train.main([a for a in CLIS[which] if a not in ("--edge-mesh", "--sim-shard")])
    for r in ranks:
        assert_histories_close(r["fgl"]["cli"][which], alone, FIT_TOL)


def test_edge_mesh_launcher_devices_2_matches_one_process():
    args = ["--servers", "2", "--clients", "4", "--rounds", "2", "--device", "cpu",
            "--sim-shard"]
    spread = edge_mesh.main(args + ["--devices", "2"])
    alone = edge_mesh.main(args)
    assert_histories_close(spread, alone, FIT_TOL)


# -- spread LM training -------------------------------------------------------------

def test_spread_training_losses_match_reference(world2):
    ref, ranks = world2
    for p, r in enumerate(ranks):
        np.testing.assert_allclose(r["spread"]["losses"], ref["lm_losses"][p], atol=1e-4,
                                   rtol=1e-4)


def test_spread_training_params_match_reference(world2):
    ref, ranks = world2
    for p, r in enumerate(ranks):
        got = jax.tree_util.tree_flatten_with_path(r["spread"]["params"])[0]
        want = dict(jax.tree_util.tree_flatten_with_path(ref["lm_params"][p])[0])
        assert len(got) == len(want)
        for path, leaf in got:
            np.testing.assert_allclose(leaf, want[path], atol=1e-4, rtol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))


def test_spawn_kills_ranks_past_its_timeout():
    """Ranks still running at ``timeout`` are killed, and spawn raises."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 3 s"):
        mesh_lib.spawn(sleep_for, 2, "cpu", args=(600,), timeout=3)
    assert time.monotonic() - t0 < 60
