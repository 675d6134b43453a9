"""One torch intra-op thread for the port's tests on the CPU.

The suite runs in several pytest-xdist workers at once, beside the JAX
package's tests. Each torch CPU op opens an OpenMP region over every core,
and when the cores are busy with other processes the region waits for
threads that are not running: one FilterReads `--mesh 2` run of
tests/test_torch_mesh_filter_reads.py's input took 30.3 s at 8 threads
and 1.05 s at one, on an 8-core host with 8 busy processes beside it
(1.59 s and 0.81 s on the idle host). Every test_torch_* module imports
this one, which sets one thread for its process; an interpreter that a
test starts gets ONE_THREAD in its environment, since torch reads
OMP_NUM_THREADS when it is imported.
"""
import torch

torch.set_num_threads(1)

ONE_THREAD = {"OMP_NUM_THREADS": "1"}
