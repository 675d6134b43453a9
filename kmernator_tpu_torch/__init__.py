"""kmernator_tpu_torch: the k-mer engine in PyTorch and CUDA.

A second package beside `kmernator_tpu`, which it is held against and
never imports. It keeps its own copies of the host modules it needs (io,
ops, parallel.spectrum and spill, the utilities, and the FilterReads,
MeraculousCounter, DistributedNucleatingAssembler and ContigExtender apps;
each copy's docstring names its source) and re-implements the device
layer in torch: canonical window extraction, the streaming shard table
(route, drain, lookup) and count_batch, with the TPU kernels rewritten as
CUDA kernels for Hopper (sm_90a): the run-length counter and the
merge-path sort.

Layer map:
  utils/device.py        explicit device choice (--device cuda|cpu)
  utils/, io/            copied host utilities and read input
  ops/kmer.py            host k-mer functions and their int64-lane twins
  ops/                   copied host weights, artifact screen, trim, dedup,
                         extensions, and the assembler's align, extend,
                         match, vmatch, external
  csrc/, kernels/        CUDA sources and their nvcc build, bound with ctypes
  parallel/run_length.py run-length counter: CUDA kernel + plain version
  parallel/merge_sort.py block sort + merge-path levels: CUDA kernels +
                         plain versions
  parallel/device_spectrum.py  extract_canonical_cols, count_batch,
                         search_lanes
  parallel/spectrum.py, spill.py  copied host spectrum and spill counter
  parallel/mesh.py, mesh_stream.py  one-device mesh, MeshStreamingSpectrum
                         (with grow-on-pressure)
  parallel/multihost.py  host collectives and gathered writes over
                         torch.distributed
  parallel/dist_match.py the assembler's read index on one device
  apps/filter_reads.py   the port's FilterReads
  apps/meraculous_counter.py, nucleating_assembler.py, contig_extender.py
  apps/generate_metagenome.py  synthetic FASTQ input

This package never imports jax or kmernator_tpu, directly or through what
it imports.
"""

__version__ = "0.1.0"
