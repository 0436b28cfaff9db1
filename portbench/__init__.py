"""portbench: the benchmark of the PyTorch and CUDA port (`trino_tpu_torch`).

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json on the card. Everything that belongs to one
configuration, traffic mix, query or metric is a file of its own, found by
its name (see README.md). Nothing here imports jax, jaxlib or the JAX
package; the plain references under `reference/` import nothing of the port.
"""
