"""The mesh data plane: a query's exchanges as collectives over shards.

Counterpart of trino_tpu/parallel/: `mesh.py` (the shard mesh and its
three collectives), `exchange.py` (the streaming group-table step),
`mesh_plan.py` (the exchange helpers, the fragment compiler and
MeshExecutor) and `mesh_chunk.py` (the chunked runner). Submodules load
on first use.
"""

__all__ = ["mesh", "exchange", "mesh_plan", "mesh_chunk"]
