"""The one traffic generator: a mix file (`mixes/<traffic>.json`) names a
query family, a number of closed-loop streams and, for each query, how
its substitution parameters are drawn. Each stream's parameters are drawn
once within those ranges, as the TPC throughput tests do, from the mix's
`params_seed`, so that every run seed does the same work (the tables
come from the configuration's `data_seed` alike); the run seed deals the
instances to the streams and gives each stream its own order of the
queries, which it then cycles through.

Parameter kinds: `int` (uniform in [lo, hi]), `date` (a uniform day in
[lo, hi]), `choice` (one of `values`) and `distinct` (as many different
`values` as it has `names`). A query's instances are distinct across the
streams where its parameter space allows.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import random
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Instance:
    id: str  # "<query>#<k>"
    query: str
    params: tuple  # ((name, value), ...)
    sql: str

    @property
    def param_dict(self) -> Dict[str, str]:
        return dict(self.params)


def load_mix(traffic: str) -> dict:
    with open(os.path.join(HERE, "mixes", f"{traffic}.json")) as f:
        return json.load(f)


def template(family: str, query: str) -> str:
    with open(os.path.join(HERE, "queries", family, f"{query}.sql")) as f:
        return f.read()


def _draw(rng: random.Random, spec: dict) -> Dict[str, str]:
    kind, names = spec["kind"], spec["names"]
    if kind == "int":
        return {names[0]: str(rng.randint(spec["lo"], spec["hi"]))}
    if kind == "date":
        lo = datetime.date.fromisoformat(spec["lo"])
        hi = datetime.date.fromisoformat(spec["hi"])
        return {names[0]: (lo + datetime.timedelta(rng.randint(0, (hi - lo).days))).isoformat()}
    if kind == "choice":
        return {names[0]: rng.choice(spec["values"])}
    if kind == "distinct":
        return dict(zip(names, rng.sample(spec["values"], len(names))))
    raise ValueError(f"unknown parameter kind {kind!r}")


def _space(spec: dict) -> int:
    kind = spec["kind"]
    if kind == "int":
        return spec["hi"] - spec["lo"] + 1
    if kind == "date":
        return (datetime.date.fromisoformat(spec["hi"])
                - datetime.date.fromisoformat(spec["lo"])).days + 1
    n = len(spec["values"])
    if kind == "choice":
        return n
    space = 1
    for i in range(len(spec["names"])):
        space *= n - i
    return space


def streams(mix: dict, seed: int) -> List[List[Instance]]:
    """Each stream's instances in the order it cycles through them.

    The parameters come from the mix's own `params_seed`, so every run
    seed serves the same set of instances, of the same sizes; the run
    seed deals them to the streams and orders each stream."""
    rng = random.Random(f"portbench-params:{mix['params_seed']}")
    family, queries = mix["family"], mix["queries"]
    texts = {q: template(family, q) for q in queries}
    drawn: Dict[str, List[tuple]] = {q: [] for q in queries}
    for q, specs in queries.items():
        space = 1
        for s in specs:
            space *= _space(s)
        for _ in range(mix["streams"]):
            while True:
                p: Dict[str, str] = {}
                for s in specs:
                    p.update(_draw(rng, s))
                params = tuple(sorted(p.items()))
                if params not in drawn[q] or len(drawn[q]) >= space:
                    break
            drawn[q].append(params)
    deal = random.Random(f"portbench-traffic:{seed}")
    out: List[List[Instance]] = [[] for _ in range(mix["streams"])]
    for q in queries:
        order = list(range(mix["streams"]))
        deal.shuffle(order)
        for k, i in enumerate(order):
            params = drawn[q][i]
            sql = texts[q]
            for name, value in params:
                sql = sql.replace("{" + name + "}", value)
            out[k].append(Instance(f"{q}#{drawn[q].index(params)}", q, params, sql))
    for stream in out:
        deal.shuffle(stream)
    return out


def distinct(stream_list: List[List[Instance]]) -> List[Instance]:
    """Every distinct instance once, in a fixed order."""
    seen: Dict[str, Instance] = {}
    for s in stream_list:
        for inst in s:
            seen.setdefault(inst.id, inst)
    return sorted(seen.values(), key=lambda i: i.id)
