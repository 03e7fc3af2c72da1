"""pytest settings of the benchmark's own tests (``perfbench/tests/``).

Run them from the checkout's root on the CPU with
``python -m pytest perfbench/tests -q``; the tests marked ``card`` need a
CUDA device and skip without one (run them on the card with
``python -m pytest perfbench/tests -q -m card``).
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped where there is none")
