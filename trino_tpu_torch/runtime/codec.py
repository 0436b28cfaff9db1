"""Typed wire codec for task specs and plan fragments.

Counterpart of trino_tpu/runtime/codec.py, byte for byte on the same
spec: a tagged, ALLOWLISTED dataclass walker over the port's plan IR
(the analogue of the Jackson JSON codecs for TaskUpdateRequest /
PlanFragment, HttpRemoteTask.java):

- encode() lowers a TaskSpec (or any registered dataclass tree) to
  JSON-compatible dicts: {"$": ClassName, "f": {field: value}} with
  explicit tags for tuples, lists, dicts, enums, bytes and dictionaries.
- decode() rebuilds the tree, refusing any class not in the registry:
  a request body can only instantiate the types listed here, never an
  arbitrary object (no pickle on a worker's port).

Callables (in-process fetch closures) are not encodable by design;
cross-process specs carry descriptor tuples (task._resolve_fetch). A
torch.Tensor is not encodable either: tensors never travel in a spec,
pages travel as serde bytes. The adaptive tier's SpooledValuesNode is
ROADMAP §1 item 13 and raises, as do the TaskSpec fields the port does
not have (shape_stabilization, capacity_ladder_base, record_output).
The registry adds one class the reference's lacks, ColumnConstraint,
without which no scan with a pushed-down predicate could cross the wire.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
from typing import Any, Dict

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.block import Dictionary
from trino_tpu_torch.connectors.spi import (
    ColumnConstraint,
    ColumnMetadata,
    Split,
    TableHandle,
)
from trino_tpu_torch.expr import ir
from trino_tpu_torch.ops.sort import SortKey
from trino_tpu_torch.sql import plan as P
from trino_tpu_torch.sql.fragmenter import PlanFragment


class CodecError(ValueError):
    pass


# wire classes of tiers the port does not have yet (ROADMAP §1)
_UNPORTED = {"SpooledValuesNode": "item 13 (adaptive/spool.py)"}


def _registry() -> Dict[str, type]:
    import trino_tpu_torch.runtime.task as task_mod
    from trino_tpu_torch.sql.stats import ColStats, PlanStats

    classes = [
        # plan IR
        P.Field, P.ScanNode, P.ValuesNode, P.FilterNode, P.ProjectNode,
        P.AggCall, P.AggregateNode, P.JoinNode, P.WindowFuncSpec,
        P.WindowNode, P.UnnestNode, P.MeasureSpec, P.MatchRecognizeNode,
        P.SortNode, P.TopNNode, P.LimitNode, P.EnforceSingleRowNode,
        P.UnionAllNode, P.OutputNode, P.ExchangeNode, P.RemoteSourceNode,
        # expression IR
        ir.InputRef, ir.Literal, ir.Call, ir.Cast, ir.Case, ir.InList,
        # support types
        T.DataType, SortKey, TableHandle, Split, ColumnMetadata,
        PlanFragment,
        # a scan's pushed-down predicates ride its TableHandle; the
        # reference's registry lacks this class, so a constrained scan
        # cannot cross its wire (ROADMAP §3)
        ColumnConstraint,
        # task layer
        task_mod.TaskId, task_mod.TaskSpec,
        # exact observed stats that travel inside fragments
        PlanStats, ColStats,
    ]
    return {c.__name__: c for c in classes}


_REGISTRY: Dict[str, type] = {}


def registry() -> Dict[str, type]:
    global _REGISTRY
    if not _REGISTRY:
        _REGISTRY = _registry()
    return _REGISTRY


def _unported(name: str) -> CodecError:
    return CodecError(
        f"wire class {name!r} is not in trino_tpu_torch yet (ROADMAP §1 "
        f"{_UNPORTED[name]})"
    )


def encode(obj: Any) -> Any:
    """Lower to JSON-compatible structures (dicts/lists/scalars)."""
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        raise CodecError(
            "a torch.Tensor in a task spec: tensors never travel on the "
            "spec wire (pages go as serde bytes)"
        )
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, int):
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, bytes):
        return {"$": "~bytes", "v": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, enum.Enum):
        # TypeKind and friends: encoded by name, decoded via the class
        return {"$": "~enum", "c": type(obj).__name__, "v": obj.name}
    if isinstance(obj, tuple):
        return {"$": "~tuple", "v": [encode(v) for v in obj]}
    if isinstance(obj, list):
        return {"$": "~list", "v": [encode(v) for v in obj]}
    if isinstance(obj, dict):
        return {
            "$": "~dict",
            "v": [[encode(k), encode(v)] for k, v in obj.items()],
        }
    if isinstance(obj, Dictionary):
        return {"$": "~strdict", "v": list(obj.values)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name in _UNPORTED:
            raise _unported(name)
        if name not in registry():
            raise CodecError(f"unregistered dataclass {name!r}")
        return {
            "$": name,
            "f": {
                f.name: encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            },
        }
    raise CodecError(f"unencodable value of type {type(obj).__name__!r}")


_ENUMS = {"TypeKind": T.TypeKind}


def decode(obj: Any) -> Any:
    """Inverse of encode(). Unknown tags raise CodecError."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    if isinstance(obj, dict):
        tag = obj.get("$")
        if tag is None:
            raise CodecError("untagged object in wire payload")
        if tag == "~bytes":
            return base64.b64decode(obj["v"])
        if tag == "~tuple":
            return tuple(decode(v) for v in obj["v"])
        if tag == "~list":
            return [decode(v) for v in obj["v"]]
        if tag == "~dict":
            return {decode(k): decode(v) for k, v in obj["v"]}
        if tag == "~strdict":
            return Dictionary(obj["v"])
        if tag == "~enum":
            cls = _ENUMS.get(obj["c"])
            if cls is None:
                raise CodecError(f"unknown enum {obj['c']!r}")
            return cls[obj["v"]]
        if tag in _UNPORTED:
            raise _unported(tag)
        cls = registry().get(tag)
        if cls is None:
            raise CodecError(f"unknown wire class {tag!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in obj.get("f", {}).items():
            if k not in fields:
                raise CodecError(f"{tag}: unknown field {k!r}")
            kwargs[k] = decode(v)
        return cls(**kwargs)
    raise CodecError(f"undecodable wire value of type {type(obj).__name__!r}")


def dumps(obj: Any) -> bytes:
    return json.dumps(encode(obj), separators=(",", ":")).encode("utf-8")


def loads(data: bytes) -> Any:
    return decode(json.loads(data.decode("utf-8")))
