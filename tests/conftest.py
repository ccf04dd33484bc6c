def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips where there is none "
        "(run on the card with: pytest -m gpu tests/test_torch_*.py)",
    )
