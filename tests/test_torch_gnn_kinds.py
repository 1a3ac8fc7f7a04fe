"""The port's GCN and GAT classifiers against the JAX package.

Logits and the engine's client-loss gradients from the reference's initial
weights, each value within 1e-5 x (1 + |reference|) (GAT's logits reach ~4,
where a few f32 ulps of a two-layer forward exceed 1e-5), a 3-round
SpreadFGL history with each kind (1e-4), and ``convert.state_from_reference``
carrying each kind's parameter tree.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import gnn as jgnn
from repro.core import registry as jreg
from repro_torch.core import fedgl as pfedgl
from repro_torch.core import gnn as pgnn
from repro_torch.core import registry as preg
from repro_torch.tree import tree_leaves, tree_map
from torch_fgl_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_fgl_parity import (OP_TOL, assert_histories_close, fit_pair, port_batch,
                              port_state)

KINDS = ("gcn", "gat")


@pytest.fixture(scope="module", params=KINDS)
def pair(request, small):
    batch, cfg = small
    cfg = dataclasses.replace(cfg, gnn_kind=request.param)
    jtr = jreg.build("SpreadFGL", cfg, batch, num_servers=2)
    ptr = preg.build("SpreadFGL", cfg, batch, num_servers=2, device="cpu")
    return request.param, jtr, ptr, jtr.init(jax.random.key(0), batch)


def test_logits_match_reference(pair):
    kind, _, _, jstate = pair
    b = jstate.batch
    want = jax.vmap(lambda p, x, a, m: jgnn.apply_classifier(p, kind, x, a, m))(
        jstate.params, b.x, b.adj, b.node_mask)
    ps = port_state(jstate)
    got = pgnn.apply_classifier(ps.params, kind, ps.batch.x, ps.batch.adj,
                                ps.batch.node_mask)
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL, rtol=OP_TOL)


def test_client_loss_and_grads_match_reference(pair):
    _, jtr, ptr, jstate = pair
    jl, jg = jax.value_and_grad(jtr._client_loss)(jstate.params, jstate.batch)
    ps = port_state(jstate)
    pl = ptr._client_loss(ps.params, ps.batch)
    pg = pfedgl._grad(lambda p: ptr._client_loss(p, ps.batch), ps.params)
    np.testing.assert_allclose(float(pl), float(jl), atol=OP_TOL, rtol=OP_TOL)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    pleaves = jax.tree.leaves(tree_map(lambda t: t.numpy(), pg))
    assert len(jleaves) == len(pleaves)
    for a, b in zip(pleaves, jleaves):
        np.testing.assert_allclose(a, b, atol=OP_TOL, rtol=OP_TOL)


def test_state_from_reference_carries_the_tree(pair):
    kind, _, ptr, jstate = pair
    ps = port_state(jstate)
    want = {"gcn": {"w", "b"}, "gat": {"w", "a_src", "a_dst", "b"}}[kind]
    assert all(set(layer) == want for layer in ps.params["layers"])
    own = ptr.init(port_batch(jstate.batch))
    for get in (lambda s: s.params, lambda s: s.opt_state.mu, lambda s: s.opt_state.nu):
        assert (sorted(t.shape for t in tree_leaves(get(ps)))
                == sorted(t.shape for t in tree_leaves(get(own))))


def test_history_matches_reference(pair):
    _, jtr, ptr, jstate = pair
    jh, ph, _ = fit_pair(jtr, ptr, jstate, 3)
    assert_histories_close(ph, jh)


def test_unknown_kind_raises(small):
    batch, cfg = small
    with pytest.raises(ValueError, match="gnn_kind"):
        preg.build("FedGL", dataclasses.replace(cfg, gnn_kind="gin"), batch, device="cpu")
