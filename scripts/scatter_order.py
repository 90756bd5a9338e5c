#!/usr/bin/env python3
"""How ``index_put_(..., accumulate=True)`` adds a cell's duplicate events on
the card, against the CPU's in-order sum, and how K9 (the port's in-order
scatter, ``particles.scatter_events`` on the card) adds them: the reason
the descent's events go through K9.

    python3 scripts/scatter_order.py

For each run length L (events a cell), 2000 cells each get a run of L
normal f32 events (seed 0), interleaved at random across the cells (a
stable sort by cell keeps each run's order).  Prints, per L and for each
of ``index_put_`` and K9 on the card, the largest difference of a cell's
sum:

* ``cpu``: one scatter on the card against the CPU's (the CPU adds each
  event to the cell in order: ``particles.scatter_events`` hands its
  ``index_put_`` at most 32767 events a call);
* ``chunks``: one scatter against 13 scatters into the same map, the event
  list cut in 13 consecutive pieces (the early-exit loop's scatter a chunk);
* ``zeros``: one scatter against one scatter of the same events with 40
  zero events put at random places inside each cell's run (the dead slots'
  events, or a rank's zeroed events of particles it does not own);
* ``again``: one scatter against the same scatter made again.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from noize_tpu_torch.erosion.particles import scatter_events  # noqa: E402

CELLS = 2000
PIECES = 13
ZEROS = 40
LENGTHS = (1, 5, 8, 31, 32, 33, 64, 100, 1000)


def events(rng, length: int, zeros: int):
    """Cells and values of CELLS runs of ``length`` events, interleaved at
    random, each run with ``zeros`` zero events put at random places in
    it; the same seed gives the same nonzero events in the same order
    whatever ``zeros`` is."""
    vals = rng.normal(0.0, 1.0, (CELLS, length)).astype(np.float32)
    order = rng.permutation(CELLS * (length + ZEROS))
    # a cell's run: its nonzero events in order with zeros at random places
    runs = np.zeros((CELLS, length + zeros), np.float32)
    for c in range(CELLS):
        slots = np.sort(rng.choice(length + zeros, length, replace=False))
        runs[c, slots] = vals[c]
    ids = np.repeat(np.arange(CELLS), length + zeros)
    ids = ids[order[order < ids.size]]
    # the k-th appearance of a cell in ``ids`` takes its run's k-th event
    rank = np.empty(ids.size, np.int64)
    sort = np.argsort(ids, kind="stable")
    rank[sort] = np.arange(ids.size) - np.repeat(np.arange(CELLS) * (length + zeros),
                                                 length + zeros)
    return ids, runs[ids, rank]


def scatter(ids, vals, device, pieces: int = 1, how: str = "k9"):
    """The per-cell sums, the events cut in ``pieces`` consecutive calls of
    ``scatter_events`` (on the card K9; on the CPU ``index_put_`` in
    order), or of one ``index_put_`` a call (``how="index_put"``)."""
    acc = [torch.zeros(CELLS, dtype=torch.float32, device=device)]
    cells = torch.from_numpy(ids).to(device)
    deltas = torch.from_numpy(vals).to(device)
    for c, d in zip(cells.tensor_split(pieces), deltas.tensor_split(pieces)):
        if how == "index_put":
            acc[0].index_put_((c,), d, accumulate=True)
        else:
            scatter_events(c, [d], CELLS, acc)
    return acc[0].cpu()


def gap(a, b) -> float:
    return float((a - b).abs().max())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("scatter_order: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {CELLS} cells, "
          f"{PIECES} pieces, {ZEROS} zeros a run")
    for length in LENGTHS:
        ids, vals = events(np.random.default_rng(length), length, 0)
        zids, zvals = events(np.random.default_rng(length), length, ZEROS)
        cpu = scatter(ids, vals, "cpu")
        # the CPU's sum does not see where the zeros are
        assert torch.equal(cpu, scatter(zids, zvals, "cpu"))
        assert torch.equal(cpu, scatter(ids, vals, "cpu", PIECES))
        for how in ("index_put", "k9"):
            one = scatter(ids, vals, "cuda", 1, how)
            print(f"L={length} {how}: cpu {gap(one, cpu):.6g}, "
                  f"chunks {gap(one, scatter(ids, vals, 'cuda', PIECES, how)):.6g}, "
                  f"zeros {gap(one, scatter(zids, zvals, 'cuda', 1, how)):.6g}, "
                  f"again {gap(one, scatter(ids, vals, 'cuda', 1, how)):.6g}")


if __name__ == "__main__":
    main()
