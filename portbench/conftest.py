"""pytest settings of the benchmark's own tests (``python3 -m pytest portbench``):
the ``cuda`` marker of tests that need a CUDA card, which skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs a cell on the card); skips without one")
