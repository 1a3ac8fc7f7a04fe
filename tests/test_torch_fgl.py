"""Slice-level parity: the port's FedGL / SpreadFGL against a live JAX run.

Both packages start from the same weights (the reference's initial state,
carried across by ``repro_torch.convert``) and the port is handed the
reference's noise S for every imputation round, derived from the reference
state's key by the same splits as ``SpreadImputation.server_outputs`` and
``FGLTrainer._train_generator``. Nothing is compared with the pinned
goldens of ``tests/test_strategy_api.py``, which do not reproduce under the
installed jax.

Tolerances: 1e-5 per op (logits, gradients); 1e-4 for anything that went
through fitted steps (the generator's Adam steps of an imputation round, or
whole training rounds), since ulp-level differences in summation order grow
through the updates. Link indices follow ``torch_parity.assert_topk_match``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gnn as jgnn
from repro.core import imputation as jimp
from repro.core.spreadfgl import make_fedgl as j_fedgl
from repro.core.spreadfgl import make_spreadfgl as j_spreadfgl
from repro_torch import convert
from repro_torch.core import fedgl as pfedgl
from repro_torch.core import gnn as pgnn
from repro_torch.core.spreadfgl import make_fedgl as p_fedgl
from repro_torch.core.spreadfgl import make_spreadfgl as p_spreadfgl
from repro_torch.launch import fgl_train
from repro_torch.tree import tree_map
from torch_parity import assert_topk_match, gram_rows

OP_TOL = 1e-5
FIT_TOL = 1e-4

BUILDS = {
    "SpreadFGL": (j_spreadfgl, p_spreadfgl, {"num_servers": 2}),
    "FedGL": (j_fedgl, p_fedgl, {}),
}


def _host(jstate):
    """The reference state on the host, without its PRNG key."""
    return jax.device_get(dataclasses.replace(jstate, key=None))


def _jax_noise(tr, jstate):
    """The reference's S for the imputation round run on ``jstate``:
    [N, M_per*n_pad, c], by the splits of server_outputs/_train_generator."""
    keys = jax.random.split(jstate.key, tr.n_servers + 1)
    n_flat = tr.m_per * jstate.batch.n_pad
    out = []
    for kj in keys[1:]:
        _, ks = jax.random.split(kj)
        out.append(np.asarray(jimp.sample_noise(ks, n_flat, tr.num_classes)))
    return torch.from_numpy(np.stack(out))


def _np(t):
    return tree_map(lambda x: x.detach().numpy(), t)


def _close_trees(p_tree, j_tree, atol, what):
    pl, jl = jax.tree.leaves(_np(p_tree)), jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(pl) == len(jl), what
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def spread_pair(small):
    batch, cfg = small
    jb, pb, kw = BUILDS["SpreadFGL"]
    jtr = jb(cfg, batch, **kw)
    ptr = pb(cfg, batch, device="cpu", **kw)
    jstate = jtr.init(jax.random.key(0), batch)
    return jtr, ptr, jstate


class TestClassifier:
    def test_apply_sage_logits(self, spread_pair):
        jtr, _, jstate = spread_pair
        b = jstate.batch
        want = jax.vmap(lambda p, x, a, m: jgnn.apply_sage(p, x, a, m))(
            jstate.params, b.x, b.adj, b.node_mask)
        ps = convert.state_from_reference(_host(jstate))
        got = pgnn.apply_sage(ps.params, ps.batch.x, ps.batch.adj, ps.batch.node_mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL)

    def test_client_loss_and_grads(self, spread_pair):
        jtr, ptr, jstate = spread_pair
        jl, jg = jax.value_and_grad(jtr._client_loss)(jstate.params, jstate.batch)
        ps = convert.state_from_reference(_host(jstate))
        pl = ptr._client_loss(ps.params, ps.batch)
        pg = pfedgl._grad(lambda p: ptr._client_loss(p, ps.batch), ps.params)
        np.testing.assert_allclose(float(pl), float(jl), atol=OP_TOL)
        _close_trees(pg, jg, OP_TOL, "client-loss grads")


def _round_parity(jtr, ptr, jstate):
    """One imputation round through server_outputs + impute, both packages."""
    ps = convert.state_from_reference(_host(jstate))
    noise = _jax_noise(jtr, jstate)
    (jae, jaeo, jas, jaso, js, ji, jx), _ = jtr.imputation.server_outputs(jtr, jstate)
    pae, paeo, pas, paso, pscores, pidx, px = ptr.imputation.server_outputs(
        ptr, ps, noise=noise)
    emb = np.asarray(jtr._embeddings(jstate.params, jstate.batch))
    h_servers = emb.reshape(jtr.n_servers, -1, emb.shape[-1])
    assert_topk_match(pscores.numpy(), pidx.numpy(), np.asarray(js), np.asarray(ji),
                      gram_rows(h_servers), atol=FIT_TOL)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=FIT_TOL)
    _close_trees((pae, pas), (jae, jas), FIT_TOL, "trained AE / assessor")
    _close_trees((paeo.mu, paeo.nu, paso.mu, paso.nu),
                 (jaeo.mu, jaeo.nu, jaso.mu, jaso.nu), FIT_TOL, "generator Adam")
    np.testing.assert_array_equal(paeo.step.numpy(), np.asarray(jaeo.step))
    jnext = jtr._impute_fn(jstate)
    pnext = ptr.imputation.impute(ptr, ps, noise=noise)
    for f in ("x", "adj", "node_mask"):
        np.testing.assert_allclose(getattr(pnext.batch, f).numpy(),
                                   np.asarray(getattr(jnext.batch, f)),
                                   atol=FIT_TOL, err_msg=f"fixed batch .{f}")
    return jnext, pnext, noise


class TestImputationRound:
    @pytest.mark.parametrize("method", ["SpreadFGL", "FedGL"])
    def test_one_round(self, small, method):
        batch, cfg = small
        jb, pb, kw = BUILDS[method]
        jtr, ptr = jb(cfg, batch, **kw), pb(cfg, batch, device="cpu", **kw)
        _round_parity(jtr, ptr, jtr.init(jax.random.key(0), batch))

    def test_second_round_after_fixing(self, spread_pair):
        jtr, ptr, jstate = spread_pair
        jnext, _, _ = _round_parity(jtr, ptr, jstate)
        assert float(jnp.sum(jnext.batch.node_mask[:, jnext.batch.n_local_max:])) > 0
        _round_parity(jtr, ptr, jnext)

    def test_batched_round_equals_per_server_loop(self, spread_pair):
        """The [N]-batched round equals running the servers one at a time."""
        jtr, ptr, jstate = spread_pair
        ps = convert.state_from_reference(_host(jstate))
        noise = _jax_noise(jtr, jstate)
        a = ptr.imputation.impute(ptr, ps, noise=noise)
        b = ptr.imputation.impute_reference(ptr, ps, noise=noise)
        for f in ("x", "adj", "node_mask"):
            torch.testing.assert_close(getattr(a.batch, f), getattr(b.batch, f),
                                       atol=OP_TOL, rtol=0)
        _close_trees(a.ae_params, jax.tree.map(np.asarray, _np(b.ae_params)),
                     OP_TOL, "AE params")


class TestFit:
    @pytest.mark.parametrize("method", ["FedGL", "SpreadFGL"])
    def test_three_round_history(self, small, method):
        batch, cfg = small
        jb, pb, kw = BUILDS[method]
        jtr, ptr = jb(cfg, batch, **kw), pb(cfg, batch, device="cpu", **kw)
        jstate = jtr.init(jax.random.key(0), batch)
        pstate = convert.state_from_reference(_host(jstate))
        # The reference's S for each imputation round, replayed from its key.
        noises, st = {}, jstate
        for r in range(3):
            if r % cfg.imputation_interval == 0:
                noises[r] = _jax_noise(jtr, st)
                st = dataclasses.replace(st, key=jax.random.split(st.key, jtr.n_servers + 1)[0])
        _, jh = jtr.fit(state=jstate, rounds=3)
        _, ph = ptr.fit(state=pstate, rounds=3, noise=noises.__getitem__)
        assert ph["round"] == jh["round"] == [0, 1, 2]
        for key in ("loss", "acc", "f1"):
            np.testing.assert_allclose(ph[key], jh[key], atol=FIT_TOL, err_msg=key)
        assert len(ph["seconds"]) == 3


def test_cli_smoke(capsys):
    hist = fgl_train.main(["--device", "cpu", "--dataset", "cora", "--scale", "0.06",
                           "--clients", "4", "--servers", "2", "--rounds", "2",
                           "--local-rounds", "1", "-K", "1", "--top-k", "3"])
    out = capsys.readouterr().out
    assert "[fgl] round   1 loss=" in out and "[fgl] best acc=" in out
    assert np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 2


@pytest.mark.parametrize("flag", [["--participation", "0.5"], ["--gossip-every", "2"],
                                  ["--async-buffer", "2"], ["--edge-mesh"],
                                  ["--method", "fedsage_plus"]])
def test_cli_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        fgl_train.main(["--device", "cpu", *flag])
