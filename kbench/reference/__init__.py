"""The benchmark's plain reference: NumPy programs that work out every
output file of a configuration's job again from the job's input file.

One module per app, named as the port's app module
(`kmernator_tpu_torch.apps.<app>`), each with
`outputs(argv, control=False) -> {file name: bytes}`. They import nothing
of the program: the host steps around the count (parsing, the artifact
screen, trimming, formatting) are frozen copies of the program's host
modules under `frozen/`, cut to the NumPy paths the configurations reach,
and the k-mer spectrum, the part the card computes, is counted here anew.
"""
