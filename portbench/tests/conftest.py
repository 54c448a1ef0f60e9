"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` runs the
CPU rehearsals; on a card, ``-m gpu`` runs a short real run of each cell."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips itself when none is present")
