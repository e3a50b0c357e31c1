"""The benchmark's tests import the harness as ``portbench`` and their
helpers as ``pbtest``; the card is looked for inside a fixture only."""

import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
for p in (HERE.parents[1], HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m gpu "
                    "portbench/tests)")
    return torch.device("cuda")
