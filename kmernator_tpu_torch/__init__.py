"""kmernator_tpu_torch: the k-mer engine's device layer in PyTorch and CUDA.

A second package beside `kmernator_tpu`. It imports the JAX package's host
modules (io, ops, parallel.spectrum, the FilterReads host engine), which
never import jax, and re-implements only the device seams: canonical
window extraction, the streaming shard table (route, drain, lookup) and
the run-length counter, which is a CUDA kernel for Hopper (sm_90a).

Layer map:
  utils/device.py        explicit device choice (--device cuda|cpu)
  ops/kmer.py            int64-lane twins of the packed-word k-mer ops
  csrc/, kernels/        CUDA sources and their nvcc build, bound with ctypes
  parallel/run_length.py run-length counter: CUDA kernel + plain version
  parallel/device_spectrum.py  extract_canonical_cols, count_batch
  parallel/mesh.py, mesh_stream.py  one-device mesh, MeshStreamingSpectrum
  apps/filter_reads.py   FilterReads with the two device seams bound to torch

This package never imports jax, directly or through what it imports.
"""

__version__ = "0.1.0"
