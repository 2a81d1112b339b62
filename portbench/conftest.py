"""pytest settings of the benchmark's own tests (python -m pytest portbench/)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch.cuda.is_available() is false")
