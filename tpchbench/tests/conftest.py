"""pytest settings of the benchmark's own tests (run them from the root of
the checkout: `python -m pytest tpchbench/tests -q`)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where none is present")
