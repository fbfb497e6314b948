"""The intra-op thread count of torch in the port's CPU tests.

Every `tests/test_torch_*.py` that runs the port imports this module (the
API walk, `tests/test_torch_api.py`, imports neither package), so a pytest
process that collects any of them runs torch at THREADS threads (`TORCH_TEST_THREADS`
in the environment overrides it). Under `pytest -n 6` six workers share
the machine's cores with the reference's JAX tests; torch's default (one
thread per core in every worker) oversubscribes them. The reference's
tests and `tests/conftest.py` are left as they are.
"""

import os

import torch

THREADS = 2

torch.set_num_threads(int(os.environ.get("TORCH_TEST_THREADS", THREADS)))
