"""TPC-H queries 1-11 through trino_tpu_torch's DistributedQueryRunner
(4 in-process workers, 4 hash partitions, the page exchange,
device="cpu") give the rows of the port's LocalQueryRunner, which
tests/test_torch_tpch_a.py and _b.py hold against the reference and the
sqlite oracle. Queries 12-22 are tests/test_torch_distributed_b.py.
Every task thread of a query has ended when its rows are back."""

import pytest

from tests.test_torch_distributed import _port_cluster, _task_threads
from tests.tpch_queries import QUERIES
from trino_tpu_torch.engine import LocalQueryRunner, Session

QIDS = [q for q in sorted(QUERIES) if q <= 11]


@pytest.fixture(scope="module")
def runners():
    cluster = _port_cluster()
    local = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    local.register_catalog("tpch", cluster.catalogs.get("tpch"))
    return cluster, local


def check(qid, runners):
    cluster, local = runners
    got = cluster.execute(QUERIES[qid])
    want = local.execute(QUERIES[qid])
    assert (got.column_names, got.column_types) == (want.column_names, want.column_types)
    assert got.rows == want.rows
    assert got.data_plane == "http"
    assert not _task_threads(), [t.name for t in _task_threads()]


@pytest.mark.parametrize("qid", QIDS)
def test_distributed_rows_equal_the_local_runner(qid, runners):
    check(qid, runners)
