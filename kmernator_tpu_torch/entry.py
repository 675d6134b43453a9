"""Entry points of the port: the twin of the repo's `__graft_entry__.py`.

entry(device)          -> (fn, example_args): the fused one-batch k-mer
                          spectrum step (`spectrum_step`) on `device`.
dryrun_multichip(n, device)
                       -> runs one step of every multi-shard path on an
                          n-shard mesh (`make_mesh(n, device)`: n shards on
                          the one device) at small shapes, with the JAX
                          dryrun's asserts, and FilterReads at `--mesh n`
                          and at `--streaming --distributed X --nprocs 1`
                          byte-identical to its host engine.

    python -m kmernator_tpu_torch.entry [--device cpu]

runs both on the card (or the CPU), the dryrun at as many shards as
there are cards (one on the CPU).
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch


def _example_batch(B, L, seed=0):
    """codes [B, L] u8, logp [B, L] float32 (phred-30-ish log2
    probabilities), lengths [B] int32: the JAX entry's example batch."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    logp = np.float32(-0.00144) * rng.integers(1, 12, (B, L)).astype(
        np.float32)
    lengths = np.full(B, L, dtype=np.int32)
    return codes, logp, lengths


def entry(device="cuda"):
    """(fn, args): fn(codes, logp, lengths) -> per-window counts [256, 70]
    int32 of spectrum_step at k = 31, args the example batch (B = 256, L =
    100, seed 0) on `device`."""
    from kmernator_tpu_torch.parallel.device_spectrum import spectrum_step

    B, L, K = 256, 100, 31

    def fn(codes, logp, lengths):
        counts, _, _ = spectrum_step(codes, logp, lengths, K)
        return counts

    args = tuple(torch.from_numpy(a).to(device)
                 for a in _example_batch(B, L))
    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One step of each multi-shard path on make_mesh(n_devices, device),
    with the JAX dryrun's inputs and asserts (each raises AssertionError
    on failure)."""
    from kmernator_tpu_torch.apps import filter_reads as fr
    from kmernator_tpu_torch.parallel.dist_match import (build_index_fn,
                                                         match_fn)
    from kmernator_tpu_torch.parallel.mesh import (distributed_count_fn,
                                                   distributed_extension_fn,
                                                   distributed_spectrum_fn,
                                                   make_mesh)
    from kmernator_tpu_torch.parallel.mesh_stream import (
        MeshStreamingSpectrum)

    K = 31
    B, L = 8 * n_devices, 64
    NW = L - K + 1
    codes, logp, lengths = _example_batch(B, L, seed=1)
    mesh = make_mesh(n_devices, device)
    dc, dl, dn = (torch.from_numpy(a).to(mesh.device)
                  for a in (codes, logp, lengths))
    # 1) the sharded spectrum (FilterReads-P analogue)
    counts, _, shard_counts, overflow = distributed_spectrum_fn(mesh, K)(
        dc, dl, dn)
    assert int(overflow.sum()) == 0
    assert tuple(counts.shape) == (B, NW)
    total = int(shard_counts.sum())
    n_windows = B * NW
    assert 0 < total <= n_windows, (total, n_windows)
    # 1b) the count path with a given good mask (FilterReads --mesh)
    good = torch.ones((B, NW), dtype=torch.bool, device=mesh.device)
    ccounts, coverflow = distributed_count_fn(mesh, K)(dc, good, dn)
    assert int(coverflow.sum()) == 0
    assert tuple(ccounts.shape) == (B, NW)
    # 2) the extension-tracking spectrum (MeraculousCounter mesh path)
    ext_ok = torch.ones((B, L), dtype=torch.bool, device=mesh.device)
    _, ec, _, eoverflow = distributed_extension_fn(mesh, K, min_count=1)(
        dc, good, ext_ok, dn)
    assert int(eoverflow.sum()) == 0
    assert int(ec.sum()) == n_windows
    # 2b) the streaming shard tables and their lookup (the FilterReads
    # --mesh two-pass path); a capacity past the batch's distinct keys, so
    # no singleton is purged
    ssp = MeshStreamingSpectrum(mesh, K, capacity=4 * n_windows)
    half = B // 2
    ssp.add_batch(codes[:half], np.ones((half, NW), bool), lengths[:half])
    ssp.add_batch(codes[half:], np.ones((B - half, NW), bool),
                  lengths[half:])
    scounts = ssp.lookup_batch(codes, np.ones((B, NW), bool), lengths,
                               min_count=1)
    assert ssp.purged_singletons == 0, ssp.purged_singletons
    assert scounts.shape == (B, NW) and int(scounts.sum()) >= n_windows
    # 3) the k-mer -> read-id matcher (assembler mesh path)
    ikeys, irid, ovf = build_index_fn(mesh, K)(
        dc, good, dn, torch.arange(B, dtype=torch.int32, device=mesh.device))
    assert ovf == 0
    queries = torch.cat(ikeys)[:4]
    ids = match_fn(mesh, K, max_ids=8)(queries, ikeys, irid)
    assert int((ids >= 0).sum()) >= 1
    # 4) the app: FilterReads' select/trim/write path at --mesh n (the
    # golden configuration on a tiny coverage-2 input), byte-identical to
    # its host engine; 5) the streaming x distributed engine at one
    # process, tiny chunks forcing several lockstep rounds
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    recs = []
    for i in range(320):
        s = int(rng.integers(0, len(genome) - 72))
        recs.append(b"@r%03d\n%s\n+\n%s\n"
                    % (i, acgt[genome[s:s + 72]].tobytes(), b"H" * 72))
    with tempfile.TemporaryDirectory() as td:
        inp = os.path.join(td, "in.fastq")
        with open(inp, "wb") as f:
            f.write(b"".join(recs))
        base = ["--device", str(mesh.device), "--kmer-scoring-type",
                "MEDIAN", "--mask-simple-repeats", "0",
                "--artifact-edit-distance", "1", "--min-read-length", "25",
                "31", inp]

        def output(prefix, args):
            assert fr.run(args + ["--out", os.path.join(td, prefix)]
                          + base) == 0
            with open(os.path.join(td, prefix + "-MinDepth2-in.fastq"),
                      "rb") as f:
                return f.read()

        want = output("h", [])
        got = output("m", ["--mesh", str(n_devices), "--mesh-batch", "64"])
        assert got and got == want, "mesh app output diverged from host"
        got_sd = output("sd", ["--streaming", "--streaming-chunk-mb",
                               "0.003", "--distributed", "127.0.0.1:1",
                               "--nprocs", "1", "--procid", "0",
                               "--mesh-batch", "64"])
        assert got_sd == want, \
            "streaming x distributed output diverged from host"


def main(argv) -> int:
    device = "cuda"
    if argv[:1] == ["--device"] and len(argv) == 2:
        device = argv[1]
    elif argv:
        print("usage: python -m kmernator_tpu_torch.entry [--device DEV]",
              file=sys.stderr)
        return 2
    fn, args = entry(device)
    out = fn(*args)
    print("entry ok:", tuple(out.shape))
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    dryrun_multichip(max(n, 1), device)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
