"""Registers the ``cuda`` marker for tests that need an NVIDIA card. Such a
test decides inside a fixture whether a card is present, and skips
without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips on a host without one)"
    )
