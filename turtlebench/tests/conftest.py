"""The benchmark's own tests: `python -m pytest turtlebench/tests -q` from
the repository's root. Tests marked `cuda` need a card and skip without
one (decided inside each test); on the card:
`python -m pytest turtlebench/tests -q -m cuda`."""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
