"""TPC-DS q72 (tests/test_tpcds.py's template) through trino_tpu_torch
(device="cpu") against trino_tpu and the sqlite oracle at SF 0.01, as
tests/test_torch_tpcds.py holds the other nine templates: rows equal to
trino_tpu's, and to the oracle's within assert_rows_match's tolerance.
It is this file alone so that --dist loadfile gives the slowest template
a worker of its own."""

import pytest

import tests.test_torch_tpcds as tpcds_parity
from tests.test_torch_tpcds import oracle, results  # noqa: F401  (fixtures)
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401


@pytest.mark.parametrize("name", ["q72"])
def test_template_matches_reference_and_oracle(name, results):  # noqa: F811
    tpcds_parity.test_template_matches_reference_and_oracle(name, results)


def test_every_template_runs_in_one_of_the_two_files():
    assert sorted(tpcds_parity.TEMPLATES + ["q72"]) == sorted(tpcds_parity.QUERIES)
