import pytest

from spmm_bench.tests.small import tiny_root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """A small copy of the benchmark with the ``tiny-gcn`` cells."""
    return tiny_root(str(tmp_path_factory.mktemp("bench")))
