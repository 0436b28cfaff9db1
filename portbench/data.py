"""Generated tables as both sides receive them: dense host numpy columns.

A string column is held as int32 codes into its sorted value list (the
order a sorted dictionary gives), so the program loads codes with their
dictionary and the reference reads the same codes. Decimals are int64
units at the column's scale, dates int32 days since 1970-01-01.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Table:
    columns: List[Tuple[str, str]]  # (name, SQL type)
    arrays: Dict[str, np.ndarray]
    dictionaries: Dict[str, List[str]]  # string columns' sorted values

    @property
    def rows(self) -> int:
        return len(next(iter(self.arrays.values())))

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())


def decimal_scale(sql_type: str) -> int:
    """The scale of 'decimal(p,s)'; 0 for any other type."""
    if not sql_type.startswith("decimal("):
        return 0
    return int(sql_type[len("decimal("):-1].split(",")[1])


def generate(generator: str, scale_factor: float, seed: int, device) -> Dict[str, Table]:
    """Run `portbench/gen/<generator>.py` on `device` from `seed` and bring
    its tables to host numpy; the device copies are freed on return."""
    mod = importlib.import_module(f"portbench.gen.{generator}")
    return mod.generate(scale_factor, seed, device)


def torch_generator(seed: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def host(t) -> np.ndarray:
    """A device tensor as a host numpy array (one copy)."""
    return t.cpu().numpy()
