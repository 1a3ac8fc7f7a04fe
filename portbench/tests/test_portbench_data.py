"""The inputs of a cell: one graph for every seed, its nodes in another order."""
import numpy as np
import pytest

from portbench import data
from portbench.tests import tiny


@pytest.fixture(scope="module")
def config():
    return tiny.cell("spreadfgl-coauthor_cs.k5").config


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_every_seed_has_the_same_clients(config, seed):
    a, b = data.host_plan(config, 1), data.host_plan(config, seed)
    sizes = lambda p: np.bincount(p.assign, minlength=p.num_clients)  # noqa: E731
    assert (sizes(a) == sizes(b)).all() and a.n_pad == b.n_pad == sizes(a).max() + a.aug_max
    assert len(a.local_edges()[0]) == len(b.local_edges()[0])
    assert not (a.labels == b.labels).all()       # the nodes are renumbered


def test_same_seed_same_inputs(config):
    a, b = data.host_plan(config, 7), data.host_plan(config, 7)
    assert all((getattr(a, f) == getattr(b, f)).all()
               for f in ("labels", "silent", "senders", "receivers", "assign", "train"))
