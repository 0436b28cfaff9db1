"""Kernel explorers on the card: counterparts of the JAX package's
benchmarks/explore_*.py, with the same shapes, seeds and record lines.

    python -m trino_tpu_torch.explore.pallas_gather
    python -m trino_tpu_torch.explore.kernel_costs

Each checks every output against its kernel's plain version and exits
nonzero when one differs or when no CUDA card is present.
"""

from __future__ import annotations


# clock cycles of the spin kernel queued ahead of each timed call: about
# 50 us at 1.98 GHz, more than the host takes to issue one launch
_SPIN_CYCLES_PER_CALL = 100_000
# bytes read between cold calls: twice the H100's 50 MB L2
_L2_FLUSH_BYTES = 100 << 20
MODES = ("warm", "cold", "host")


def device_ms(fn, iters: int = 20, mode: str = "warm") -> float:
    """Mean milliseconds of one call of `fn` on the card, from CUDA
    events after one warm-up call.

    - "warm": events around `iters` calls queued behind a spin kernel, so
      the card runs them back to back and the host's cost of issuing a
      launch leaves no gap between them; inputs that fit stay in L2.
    - "cold": behind the same spin, a read of twice the L2's size before
      each call (it leaves the L2 holding clean lines of another buffer)
      and events around each call alone: the time of a caller that finds
      its inputs in device memory, not in L2.
    - "host": events around `iters` calls issued with no spin, so the
      card waits on the host whenever issuing a call takes longer than
      running it: the time of a caller that launches one call after
      another from Python."""
    import torch

    if mode not in MODES:
        raise ValueError(f"device_ms: mode {mode!r} not in {MODES}")
    cold = mode == "cold"
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(_L2_FLUSH_BYTES if cold else 0, dtype=torch.uint8, device="cuda")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters if cold else 2)]
    if mode != "host":
        # a cold call issues four operations, so it queues a longer spin
        torch.cuda._sleep(_SPIN_CYCLES_PER_CALL * iters * (4 if cold else 1))
    if cold:
        for i in range(iters):
            flush.sum()
            marks[2 * i].record()
            fn()
            marks[2 * i + 1].record()
    else:
        marks[0].record()
        for _ in range(iters):
            fn()
        marks[1].record()
    torch.cuda.synchronize()
    return sum(marks[i].elapsed_time(marks[i + 1]) for i in range(0, len(marks), 2)) / iters


def q_mxu_like_ids(rng, n: int):
    """int32 group ids shaped like the bounded-domain GROUP BY of TPC-H
    lineitem by (returnflag, linestatus, shipmode, shipinstruct): slot
    ((rf * 3 + ls) * 8 + mode) * 5 + instruct of 480, over the four
    (returnflag, linestatus) pairs at lineitem's shares, seven ship modes
    and four instructions, so 112 slots are hit. `rng` is a numpy
    Generator."""
    import numpy as np

    pairs = np.array([0 * 3 + 0, 1 * 3 + 0, 1 * 3 + 1, 2 * 3 + 0])  # AF NF NO RF
    pair = pairs[rng.choice(4, n, p=[0.25, 0.0065, 0.4935, 0.25])]
    mode = rng.integers(0, 7, n)
    instruct = rng.integers(0, 4, n)
    return ((pair * 8 + mode) * 5 + instruct).astype(np.int32)


def atomic_opcodes(library: str) -> dict:
    """{SASS opcode: count} of the atomic instructions in a built kernel
    library, from `cuobjdump -sass`: ATOMS.* on shared memory, ATOM,
    ATOMG, RED and REDG on device memory. It tells a native add (ATOMS.ADD)
    from a compare-and-swap loop (ATOMS.CAS, ATOMS.CAST.SPIN)."""
    import os
    import re
    import subprocess

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    counts: dict = {}
    for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", text):
        counts[op] = counts.get(op, 0) + 1
    return counts
