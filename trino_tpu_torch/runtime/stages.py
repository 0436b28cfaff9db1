"""Stage-planning helpers shared by the pipelined and FTE schedulers:
topological fragment order, task-count policy, and the coordinator-side
schema-propagation pass (StageManager/DeterminePartitionCount-adjacent
logic that must not diverge between scheduling modes)."""

from __future__ import annotations

from typing import Dict, List

from trino_tpu_torch.sql.fragmenter import SubPlan


def topo_order(subplan: SubPlan) -> List[SubPlan]:
    """Children before parents (producers schedule before consumers)."""
    out: List[SubPlan] = []

    def walk(sp: SubPlan) -> None:
        for c in sp.children:
            walk(c)
        out.append(sp)

    walk(subplan)
    return out


def stage_task_count(sp: SubPlan, n_workers: int, hash_partitions: int) -> int:
    """Task-count policy per fragment partitioning; hash stages take the
    stats-driven suggestion (DeterminePartitionCount.java:90) capped by
    the session's hash_partition_count."""
    p = sp.fragment.partitioning
    if p == "single":
        return 1
    if p == "source":
        return max(1, n_workers)
    suggested = sp.fragment.suggested_partitions
    if suggested is not None:
        return max(1, min(hash_partitions, suggested))
    return hash_partitions


def fragment_schema(catalogs, session, sp: SubPlan, remote: Dict[int, list],
                    device) -> list:
    """Coordinator-side planning pass for a fragment's output schema
    (dictionaries included) so consumer fragments can bind expressions.
    It plans on the runner's `device`, as its tasks will."""
    from trino_tpu_torch.sql.local_planner import LocalPlanner

    planner = LocalPlanner(
        catalogs,
        device,
        batch_rows=session.batch_rows,
        remote_schemas=remote,
    )
    return planner.plan(sp.fragment.root).schema
