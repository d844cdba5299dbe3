"""Fixtures of the benchmark's CPU tests (``python -m pytest benchmark/tests``)."""

import pytest

from benchmark.tests import toy


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    return toy.make(tmp_path_factory.mktemp("toy"))
