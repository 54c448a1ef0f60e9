"""One CPU thread for torch in every process of the port's CPU tests.

The tier-1 suite runs under pytest-xdist, 6 workers on an 8-core machine.
Each worker's torch would otherwise keep 8 intra-op OpenMP threads: 48
spinning threads on 8 cores, under which a test that takes 18 s alone took
minutes. Every ``tests/test_torch_*.py`` that runs on the CPU imports this
module before anything else, so that the cap holds in each worker from
collection on, and in a file run alone. ``OMP_NUM_THREADS`` carries it to
the processes the tests spawn (the gloo ranks of
``tests/torch_dist_worker.py``, the surrogate generators' worker
processes), whose torch reads it when it starts.

``tests/conftest.py`` is the intended home of this once that file, which
predates the port, may change.
"""

import os

os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
