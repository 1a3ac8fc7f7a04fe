"""Helpers of the port's FGL parity tests: the reference's state, noise and
participation masks handed to the port, and whole fits of both packages
side by side (tests/test_torch_{fgl,strategies,gnn_kinds,checkpoint}.py).

Both packages start from the reference's initial state (carried across by
``repro_torch.convert``). The port is handed the reference's noise S of
every imputation round, replayed from the reference state's key by the
splits of ``SpreadImputation.server_outputs`` and
``FGLTrainer._train_generator``, and the reference's participation mask of
every round.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import imputation as jimp
from repro.core import strategies as JS
from repro_torch import convert

OP_TOL = 1e-5
FIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the importing module's tests. These
    tests run many small ops; with pytest-xdist every worker would otherwise
    start a thread per core, and the workers' threads oversubscribe the CPU
    (a 6-worker run on 8 cores ran these files ~7x slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def host(jstate):
    """The reference state on the host, without its PRNG key."""
    return jax.device_get(dataclasses.replace(jstate, key=None))


def port_batch(batch, device="cpu"):
    """The reference's ClientBatch as the port's."""
    return convert.batch_to_torch(batch, device)


def port_state(jstate, device="cpu"):
    """The reference state as the port's."""
    return convert.state_from_reference(host(jstate), device=device)


def jax_noise(tr, jstate):
    """The reference's S for the imputation round run on ``jstate``:
    [N, M_per*n_pad, c], by the splits of server_outputs/_train_generator."""
    keys = jax.random.split(jstate.key, tr.n_servers + 1)
    n_flat = tr.m_per * jstate.batch.n_pad
    out = []
    for kj in keys[1:]:
        _, ks = jax.random.split(kj)
        out.append(np.asarray(jimp.sample_noise(ks, n_flat, tr.num_classes)))
    return torch.from_numpy(np.stack(out))


def replay_noises(jtr, jstate, rounds):
    """{round: S} for every SpreadFGL imputation round of the next ``rounds``
    rounds from ``jstate``, following the reference's key."""
    noises, st = {}, jstate
    if not isinstance(jtr.imputation, JS.SpreadImputation):
        return noises
    for r in range(int(jstate.round), int(jstate.round) + rounds):
        if r % jtr.cfg.imputation_interval == 0:
            noises[r] = jax_noise(jtr, st)
            st = dataclasses.replace(
                st, key=jax.random.split(st.key, jtr.n_servers + 1)[0])
    return noises


def jax_masks(jtr):
    """The port's ``fit(mask=)``: the reference's participation mask of a
    round (None at rho = 1)."""
    def mask(r):
        m = jtr._participation_mask(r)
        return None if m is None else torch.from_numpy(np.array(m))
    return mask


def fit_pair(jtr, ptr, jstate, rounds):
    """Fit both packages ``rounds`` rounds from the reference's ``jstate``;
    returns (reference history, port history, port state)."""
    noises = replay_noises(jtr, jstate, rounds)
    pstate = port_state(jstate)
    _, jh = jtr.fit(state=jstate, rounds=rounds)
    pst, ph = ptr.fit(state=pstate, rounds=rounds, noise=noises.get,
                      mask=jax_masks(jtr))
    return jh, ph, pst


def assert_histories_close(ph, jh, atol=FIT_TOL):
    assert ph["round"] == jh["round"]
    for key in ("loss", "acc", "f1"):
        np.testing.assert_allclose(ph[key], jh[key], atol=atol, err_msg=key)
