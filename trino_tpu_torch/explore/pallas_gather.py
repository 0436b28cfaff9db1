"""Gather formulations for the bucket-hash probe, on the card.

Counterpart of benchmarks/explore_pallas_gather.py: the same three
variants at the same shapes and seed (1M lookups into a 128K-entry
int32 table), each now a hand-written CUDA kernel
(ops/gather_kernels.py, csrc/gather.cu):

  pallas_take_flat         out = table[idx]                  (take_flat)
  pallas_take_rows128      out[i] = sum_l table2d[ridx[i], l] (take_rows_sum, int32 wrap)
  pallas_take_along_lanes  out[r, l] = src[r, sel[r, l]]      (take_along_lanes)

Prints one {"bench", "ms", "gb_s"} line per variant (gb_s counts 8 bytes
per lookup, as the JAX explorer does) and a `correct:` line holding the
output against the kernel's plain version. Run on a machine with a card:

    python -m trino_tpu_torch.explore.pallas_gather
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from trino_tpu_torch.explore import device_ms
from trino_tpu_torch.ops import gather_kernels as GK

N = 1 << 20
B = 1 << 17
TILE = 2048  # probe rows per grid step of the TPU kernel
ROWT = 512


def make_inputs(device) -> dict:
    """The JAX explorer's arrays, drawn in its order from its seed."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 30, B).astype(np.int32)
    idx = rng.integers(0, B, N).astype(np.int32)
    ridx = rng.integers(0, B // 128, N).astype(np.int32)
    sel = rng.integers(0, 128, (N // 128, 128)).astype(np.int32)
    src = rng.integers(0, 1 << 30, (N // 128, 128)).astype(np.int32)

    def dev(x):
        return torch.from_numpy(x).to(device)

    return {
        "table2d": dev(table.reshape(B // 128, 128)),
        "idx2d": dev(idx.reshape(N // TILE, TILE)),
        "ridx2d": dev(ridx.reshape(N // ROWT, ROWT)),
        "src": dev(src),
        "sel": dev(sel),
    }


def variants(x: dict):
    """(bench name, kernel call, bare launch for timing, plain version)."""
    table = x["table2d"].reshape(-1)
    return [
        ("pallas_take_flat",
         lambda: GK.take_flat(table, x["idx2d"]),
         lambda: GK.flat_launcher(table, x["idx2d"])[0],
         lambda: GK.take_flat_reference(table, x["idx2d"])),
        ("pallas_take_rows128",
         lambda: GK.take_rows_sum(x["table2d"], x["ridx2d"]),
         lambda: GK.rows_sum_launcher(x["table2d"], x["ridx2d"])[0],
         lambda: GK.take_rows_sum_reference(x["table2d"], x["ridx2d"])),
        ("pallas_take_along_lanes",
         lambda: GK.take_along_lanes(x["src"], x["sel"]),
         lambda: GK.along_launcher(x["src"], x["sel"])[0],
         lambda: GK.take_along_lanes_reference(x["src"], x["sel"])),
    ]


def run(iters: int = 20) -> list:
    """Each variant once through its wrapper, held against the plain
    version, then timed as bare kernel launches (device time)."""
    x = make_inputs("cuda")
    records = []
    for name, kernel, bare, plain in variants(x):
        correct = bool(torch.equal(kernel(), plain()))
        ms = device_ms(bare(), iters)
        rec = {"bench": name, "ms": ms, "gb_s": N * 8 / (ms / 1e3) / 1e9}
        print(json.dumps(rec), flush=True)
        print("correct:", correct, flush=True)
        records.append(dict(rec, correct=correct))
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("pallas_gather: no CUDA device", file=sys.stderr)
        return 2
    return 0 if all(r["correct"] for r in run()) else 1


if __name__ == "__main__":
    sys.exit(main())
