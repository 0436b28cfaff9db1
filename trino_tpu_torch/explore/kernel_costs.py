"""The merge kernel's in-window count step, on the card.

Counterpart of benchmarks/explore_kernel_costs.py: the same five
variants at the same shapes and seed (a (131072, 8) int32 probe against
a (1024, 128) int32 table), each now the windowed-rank CUDA kernel
(ops/window_rank.py, csrc/window_rank.cu) in fixed mode:

  v0, v1, v2   2 windows (the TPU variants differed only in how Mosaic
               lowered the loop; v2's SMEM start is 0, so its windows are
               0..1 as well)
  v3           2 windows plus the int32 sum of each window's first and
               last element (the scalar reads)
  v4           8 windows

Prints `tag ms` per variant, as the JAX explorer does, and a `correct:`
line holding the output against the kernel's plain version. Run on a
machine with a card:

    python -m trino_tpu_torch.explore.kernel_costs
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from trino_tpu_torch.explore import device_ms
from trino_tpu_torch.ops import window_rank as W

N = 1 << 20
GRID = N // 1024

# (tag, windows, edge sum)
VARIANTS = (
    ("v0 2win static unrolled", 2, False),
    ("v1 2win fori dynamic-ds", 2, False),
    ("v2 2win fori smem-bound", 2, False),
    ("v3 2win + scalar vmem reads", 2, True),
    ("v4 8win static unrolled", 8, False),
)


def make_inputs(device):
    """(at, b): the JAX explorer's arrays from its seed; b flattened."""
    rng = np.random.default_rng(0)
    at = rng.integers(0, 1 << 30, (GRID * 128, 8)).astype(np.int32)
    b2 = rng.integers(0, 1 << 30, (1024, 128)).astype(np.int32)
    return (torch.from_numpy(at).to(device),
            torch.from_numpy(b2.reshape(-1)).to(device))


def run(iters: int = 20) -> list:
    at, b = make_inputs("cuda")
    records = []
    for tag, nwin, edge in VARIANTS:
        def kernel(nwin=nwin, edge=edge):
            return W.rank(at, b, False, 0, nwin, edge)

        correct = bool(torch.equal(
            kernel(), W.rank_reference(at, b, False, 0, nwin, edge)))
        # device time: bare launches, without the wrapper's checks
        ms = device_ms(W.launcher(at, b, False, 0, nwin, edge)[0], iters)
        print(tag, ms, "ms", flush=True)
        print("correct:", correct, flush=True)
        records.append({"tag": tag, "ms": ms, "correct": correct})
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_costs: no CUDA device", file=sys.stderr)
        return 2
    return 0 if all(r["correct"] for r in run()) else 1


if __name__ == "__main__":
    sys.exit(main())
