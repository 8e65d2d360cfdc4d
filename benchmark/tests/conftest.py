"""Settings of the benchmark's own tests: the repository's root on the
import path, and the ``card`` marker of tests that need a CUDA card (they
decide inside the test whether one is present, and skip without it)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
