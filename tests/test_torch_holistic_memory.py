"""The holistic and sketch aggregates over memory tables: the cases of
tests/test_aggregates_r4.py and tests/test_approx_aggs.py
(test_torch_holistic.MEMORY_CASES) through trino_tpu_torch (device="cpu")
and trino_tpu on the same tables. Integers, decimals and strings equal;
doubles summed in another order (avg, regr_*) within assert_rows_match's
tolerance, every other double equal. tests/test_torch_holistic.py holds
the reducers, the sketch expressions and the tpch cases.
"""

import pytest

from tests.oracle import assert_rows_match
from tests.test_torch_holistic import MEMORY_CASES, memory_runners  # noqa: F401  (fixture)
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401


@pytest.mark.parametrize("sql,float_sums", MEMORY_CASES)
def test_memory_aggregates_match_reference(sql, float_sums, memory_runners):  # noqa: F811
    # float_sums: avg/regr over doubles add in another order, so those
    # doubles agree within assert_rows_match's 1e-9 relative
    ref, port = memory_runners
    got, want = port.execute(sql).rows, ref.execute(sql).rows
    if float_sums:
        assert_rows_match(got, want, ordered=True)
    else:
        assert got == want
