import pytest


@pytest.fixture(autouse=True)
def one_thread():
    """Toy shapes gain nothing from many threads, and the test run's
    workers share the cores: each bench test runs on one,
    and the setting is put back after it."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
