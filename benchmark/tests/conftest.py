"""Shared fixtures of the benchmark's CPU tests: the tiny checkout
(``tiny.make_root``), made once per session."""

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))
