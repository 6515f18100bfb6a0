"""The benchmark's own tests: ``python -m pytest portbench/tests``. The
``cuda`` marker names tests that need an NVIDIA card; each decides inside
the test whether one is there."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without CUDA")
