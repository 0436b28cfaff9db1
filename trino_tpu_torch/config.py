"""Config + session-property system.

Analogue of airlift @Config binding (etc/config.properties -> typed
config objects; 353 @Config annotations in trino-main) and the typed
session-property registry (main/SystemSessionProperties.java, ~200
properties — SURVEY.md §5.6). Properties are declared once with type +
default + description; SET SESSION goes through `validate`, and config
files bind by the same registry."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    name: str
    type: type  # bool | int | float | str
    default: Any
    description: str
    allowed: Optional[tuple] = None  # enum-valued string properties

    def parse(self, text: str) -> Any:
        if self.type is bool:
            if text.lower() in ("true", "1", "on"):
                return True
            if text.lower() in ("false", "0", "off"):
                return False
            raise ValueError(f"{self.name}: expected boolean, got {text!r}")
        return self.type(text)


class PropertyRegistry:
    def __init__(self):
        self._props: Dict[str, PropertyMetadata] = {}

    def register(
        self, name: str, type_: type, default, description: str,
        allowed: Optional[tuple] = None,
    ) -> None:
        self._props[name] = PropertyMetadata(
            name, type_, default, description, allowed
        )

    def validate(self, name: str, value: Any) -> Any:
        meta = self._props.get(name)
        if meta is None:
            raise ValueError(f"unknown session property {name!r}")
        if isinstance(value, str) and meta.type is not str:
            value = meta.parse(value)
        elif meta.type is float and isinstance(value, int):
            value = float(value)
        elif not isinstance(value, meta.type):
            raise ValueError(
                f"{name}: expected {meta.type.__name__}, got {type(value).__name__}"
            )
        if meta.allowed is not None and value not in meta.allowed:
            raise ValueError(
                f"{name}: must be one of {meta.allowed}, got {value!r}"
            )
        return value

    def default(self, name: str) -> Any:
        return self._props[name].default

    def all(self) -> List[PropertyMetadata]:
        return sorted(self._props.values(), key=lambda m: m.name)


# The engine's system session properties (SystemSessionProperties
# analogue): one per field of the port's engine.Session. The reference's
# properties for its distributed, retry, mesh, serving, resident,
# adaptive, recovery, validation and tracing tiers come with those tiers.
SYSTEM_PROPERTIES = PropertyRegistry()
for _name, _type, _default, _desc, _allowed in [
    ("batch_rows", int, 1 << 20, "max rows per device batch", None),
    ("target_splits", int, 1, "target connector split count per scan", None),
    ("enable_optimizer", bool, True,
     "run the iterative plan-optimizer pipeline", None),
    ("enable_pushdown", bool, True,
     "push supported filter conjuncts and projections into connector "
     "scans (apply_filter/apply_projection SPI)", None),
    ("join_reordering_strategy", str, "automatic",
     "cost-based join reordering: automatic | none",
     ("automatic", "none")),
    ("mxu_join_enabled", bool, False,
     "plan a grouped aggregate over a high-fanout inner equi-join as the "
     "join-project route (ops/mxu_join.py: per-key grouped sums, no pair "
     "expansion) when profitable", None),
    ("mxu_join_min_work", float, 16.0,
     "estimated fanout x build-NDV product at or above which the "
     "join-project route is selected over the expanding join", None),
]:
    SYSTEM_PROPERTIES.register(_name, _type, _default, _desc, _allowed)


def load_properties_file(path: str) -> Dict[str, str]:
    """key=value config file (etc/config.properties format: # comments,
    blank lines ignored)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"malformed config line: {line!r}")
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def bind_session(session, overrides: Dict[str, Any]) -> None:
    """Apply validated property values onto a Session (the
    SessionPropertyManager.validate path)."""
    for name, value in overrides.items():
        setattr(session, name, SYSTEM_PROPERTIES.validate(name, value))
