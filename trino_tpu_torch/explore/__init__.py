"""Kernel explorers on the card: counterparts of the JAX package's
benchmarks/explore_*.py, with the same shapes, seeds and record lines.

    python -m trino_tpu_torch.explore.pallas_gather
    python -m trino_tpu_torch.explore.kernel_costs

Each checks every output against its kernel's plain version and exits
nonzero when one differs or when no CUDA card is present.
"""

from __future__ import annotations


def device_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of one call of `fn` on the card, from CUDA
    events around `iters` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
