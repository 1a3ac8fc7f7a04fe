"""One intra-op thread for the benchmark's tests: the suite runs them
beside other test workers, and small ops on many spinning threads each
slow every worker down."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
