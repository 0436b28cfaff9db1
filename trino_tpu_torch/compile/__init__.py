"""Compile regime: the capacity-class ladder.

Counterpart of trino_tpu/compile/. Only `shapes` (CapacityLadder, the
ShapeStabilizer policy) is here: the mesh plane's chunk runner picks
its chunk capacities from the ladder. The program cache and the warmup
service (`cache.py`, `warmup.py`) are ROADMAP §1 item 13.1.
"""

__all__ = ["shapes"]
