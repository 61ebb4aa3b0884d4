"""Pytest settings for tests/: registers the `gpu` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's kernels); skips without one "
        "— run on the card with `python -m pytest -m gpu tests/`")
