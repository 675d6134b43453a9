"""Shared by the harness's tests: a tiny traffic and a run on the CPU."""
from __future__ import annotations

import time

import torch

from kbench import harness

# 13,332 reads of 150 bp (4.2 MB): over the 2 MB at which FilterReads
# streams on its own, as the cells' inputs do
TINY = dict(genomes=4, total_genome_mb=0.1, coverage=20, read_length=150,
            error_rate=0.005, warmup_mb=2.5)
SEED = 3_000_000_019  # past 32 signed bits, as the checks' seeds are


def run_cpu(cell: str, trace: bool = False, ranks: int = None,
            seed: int = SEED, config: str = None) -> dict:
    """One run of the cell on the CPU at TINY: one job in the window.
    `config` runs another configuration in the cell's place."""
    torch.set_num_threads(2)
    return harness.run(cell, seed, 0.01, trace, time.perf_counter(),
                       device="cpu", traffic=TINY, ranks=ranks,
                       config=config)
