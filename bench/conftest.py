"""pytest settings of the benchmark's tests.

`card` marks a test that needs an NVIDIA card; such a test takes the
`card` fixture, which decides at run time (never at import or collection)
and skips without one.  Run them on the card with
`python -m pytest -q -m card bench`.

The CPU tests run the port at small widths, where intra-op threads buy
nothing and, beside other test workers, cost many times the run: each
test runs on one thread.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device in this process")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
