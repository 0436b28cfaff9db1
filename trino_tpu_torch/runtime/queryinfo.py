"""QueryInfo/TaskInfo aggregation: Driver -> Task -> Stage -> Query.

Analogue of the reference's QueryInfo/StageInfo/TaskInfo JSON tree
(QueryResource GET /v1/query/{id}; StageStateMachine rolling operator
summaries up from task status — SURVEY.md §5.1). Workers report raw
per-pipeline OperatorStats dicts in task status; this module merges them
positionally per stage (same fragment -> same operator layout) and
flattens everything into one plain-data dict the server can serve
and EXPLAIN ANALYZE can render. Shared by the coordinator's pipelined
and FTE paths so the two cannot drift apart.

Counterpart of trino_tpu/runtime/queryinfo.py. The reference also
attaches each stage's expected and observed XLA lowering counts (the
shape census and the operators' shape ledger); those count XLA programs
and wait for the compile tier (ROADMAP §1 item 13), so a port stage
carries neither key and EXPLAIN ANALYZE prints no lowerings line."""

from __future__ import annotations

from typing import Dict, List, Optional


def merge_operator_stats(
    per_task: List[List[List[dict]]],
) -> List[List[dict]]:
    """Sum numeric OperatorStats fields positionally across a stage's
    tasks: every task of a fragment runs the same pipeline layout, so
    (pipeline index, operator index) identifies the same operator.
    Non-numeric fields (operator name, device_synced bool) keep the
    first task's value; device_synced ORs so one synced task marks the
    merged line."""
    merged: List[List[dict]] = []
    for groups in per_task:
        if groups is None:
            continue
        for pi, group in enumerate(groups):
            while len(merged) <= pi:
                merged.append([])
            for oi, op in enumerate(group):
                if oi >= len(merged[pi]):
                    merged[pi].append(dict(op))
                else:
                    acc = merged[pi][oi]
                    for k, v in op.items():
                        if isinstance(v, bool):
                            acc[k] = bool(acc.get(k)) or v
                        elif isinstance(v, (int, float)):
                            acc[k] = acc.get(k, 0) + v
    return merged


def build_task_info(task_id: str, state: dict) -> dict:
    """One task attempt's TaskInfo from its worker status dict."""
    start = state.get("start_time")
    end = state.get("end_time")
    wall = (end - start) if (start is not None and end is not None) else None
    return {
        "task_id": task_id,
        "state": state.get("state"),
        "failure": state.get("failure"),
        "cpu_s": float(state.get("cpu_s") or 0.0),
        "wall_s": wall,
        "operator_stats": state.get("stats"),
    }


def build_stage_info(fragment_id: int, task_infos: List[dict]) -> dict:
    """Stage rollup: merged operator lines + totals over the stage's
    task attempts."""
    merged = merge_operator_stats(
        [t.get("operator_stats") for t in task_infos]
    )
    flat = [op for group in merged for op in group]
    info = {
        "fragment_id": fragment_id,
        "tasks": len(task_infos),
        "task_infos": task_infos,
        "operator_summaries": merged,
        "cpu_s": sum(t["cpu_s"] for t in task_infos),
        "wall_s": max(
            (t["wall_s"] for t in task_infos if t["wall_s"] is not None),
            default=None,
        ),
        "input_rows": sum(int(op.get("input_rows") or 0) for op in flat),
        "output_rows": sum(int(op.get("output_rows") or 0) for op in flat),
        "device_synced": any(bool(op.get("device_synced")) for op in flat),
    }
    return info


def build_query_info(
    query_id: str,
    state: str,
    sql: str = "",
    wall_s: float = 0.0,
    stages: Optional[List[dict]] = None,
    peak_memory_bytes: int = 0,
    compile_count: int = 0,
    counters: Optional[Dict[str, float]] = None,
    error_code: Optional[str] = None,
    failure: Optional[str] = None,
    retry_count: int = 0,
    attempt_count: int = 1,
    data_plane: str = "http",
    mesh_fallback: Optional[str] = None,
) -> dict:
    """The final QueryInfo document. Counters are the engine-counter
    deltas (rows_scanned/bytes_scanned/rows_shuffled/...) attributed to
    this query; peak memory is the sum of per-worker pool watermarks —
    an upper bound on any instant's cluster-wide total, exact when one
    worker dominates."""
    stages = stages or []
    return {
        "query_id": query_id,
        "state": state,
        "sql": sql,
        "wall_s": wall_s,
        "cpu_s": sum(s.get("cpu_s") or 0.0 for s in stages),
        "peak_memory_bytes": int(peak_memory_bytes),
        "compile_count": int(compile_count),
        "counters": dict(counters or {}),
        "error_code": error_code,
        "failure": failure,
        "retry_count": int(retry_count),
        "attempt_count": int(attempt_count),
        "data_plane": data_plane,
        # why the query left the mesh plane (None = it ran there, or
        # never would have — read together with data_plane)
        "mesh_fallback": mesh_fallback,
        "stages": stages,
    }


def stage_text(stage: dict) -> str:
    """EXPLAIN ANALYZE rendering of one stage's rollup: the merged
    operator lines through the shared OperatorStats formatter (so local
    and distributed output cannot drift apart), then one summary line
    per task attempt — the per-worker detail the merged lines lose."""
    from trino_tpu_torch.exec.stats import OperatorStats, render_stats

    groups = [
        [OperatorStats(**{k: v for k, v in op.items()
                          if k in OperatorStats.__dataclass_fields__})
         for op in group]
        for group in stage["operator_summaries"]
    ]
    lines = [
        f"\nFragment {stage['fragment_id']} [{stage['tasks']} tasks]:",
        render_stats(groups),
    ]
    if stage.get("estimated_vs_observed"):
        lines.append(stage["estimated_vs_observed"])
    for t in stage["task_infos"]:
        wall = t.get("wall_s")
        wall_txt = f"{wall * 1000:.1f}ms" if wall is not None else "?"
        rows = 0
        for group in t.get("operator_stats") or []:
            for op in group:
                rows = max(rows, int(op.get("output_rows") or 0))
        lines.append(
            f"  task {t['task_id']}: {t.get('state')} "
            f"wall={wall_txt} cpu={t['cpu_s'] * 1000:.1f}ms "
            f"peak_rows={rows}"
        )
    return "\n".join(lines)
