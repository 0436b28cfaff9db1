"""Scale factors a CPU test can hold at which the cell's queries have rows
to compare (TPC-DS's item filters select almost nothing at SF 0.01)."""

TINY = {"tpch_sf10": 0.01, "tpcds_sf10": 0.1}


def tiny(cell: str) -> float:
    return TINY[cell.split(".")[0]]
