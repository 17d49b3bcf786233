"""The benchmark's tests: CPU tests run everywhere; tests marked
``chip`` need a CUDA card and decide so inside the test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
