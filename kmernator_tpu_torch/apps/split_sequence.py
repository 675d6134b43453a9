"""SplitSequenceOnTheFly: stream a partition of the input to files/pipes
with {Uniq}/{FileNum}/{NumFiles}/{UniqFirst}/{UniqSecond} name templating
(ref: apps/SplitSequenceOnTheFly.cpp:60-670).

Partitions are byte ranges with pair-preserving record resync (identical
algorithm to ReadFileReader::seekToNextRecord), streamed as raw bytes so the
concatenation of all partitions reproduces the input exactly (the
runSplitSequenceOnTheFlyTests.sh invariant).  --split-file separates the
two reads of interleaved pairs into two outputs.

Copied for kmernator_tpu_torch from kmernator_tpu/apps/split_sequence.py.
It differs from its source in its package imports and in accepting
`--device cuda|cpu`, as the port's other apps do, and ignoring it
(utils/device.py `drop_device`): the app runs on the host whichever device
is named, with or without a visible GPU.
The FIFOs it makes are registered with the port's utils/cleanup.py.
"""
from __future__ import annotations

import subprocess
import sys
from typing import List

from kmernator_tpu_torch.io.reads import (open_maybe_gzip, extract_partition,
                                          parse_fastq_bytes, _split_name_line,
                                          read_num)
from kmernator_tpu_torch.utils.options import GeneralOptions, compose
from kmernator_tpu_torch.utils.device import drop_device


_bool = lambda v: str(v).lower() not in ("0", "false", "")


class _SSOptions:
    FLAGS = {"num-files": int, "file-num": int, "second-dim": int,
             "split-file": str, "pipe-command": str,
             "trim-pair-in-name": _bool,
             "output-fifo": _bool, "extra-fifo": list, "fork-command": list,
             "merge": list, "even-chunks": int, "min-read-length": int,
             "min-bytes-per-record": int, "max-percent-for-fseek": int}

    def __init__(self):
        self.num_files = 1
        self.file_num = 0
        self.second_dim = 0
        self.split_file = ""
        self.pipe_command = ""
        self.trim_pair_in_name = False
        self.output_fifo = False
        self.extra_fifo = []
        self.fork_command = []
        self.merge = []
        self.even_chunks = 1          # ordering knob; single-image output
        self.min_read_length = 0      # is already contiguous per partition
        self.min_bytes_per_record = 100   # partition-resync tuning knobs:
        self.max_percent_for_fseek = 20   # accepted; resync is exact here


def replace_keys(s: str, file_num: int, num_files: int, second_dim: int) -> str:
    """ref: _SSOptions::_replaceWithKeys."""
    s = s.replace("{Uniq}", "%06dof%06d" % (file_num, num_files))
    s = s.replace("{FileNum}", "%06d" % file_num)
    s = s.replace("{NumFiles}", "%06d" % num_files)
    if second_dim > 0:
        first = file_num // second_dim
        second = file_num % second_dim
        first_dim = num_files // second_dim
        s = s.replace("{FirstNum}", "%06d" % first)
        s = s.replace("{SecondNum}", "%06d" % second)
        s = s.replace("{UniqFirst}", "%06dof%06d" % (first, first_dim))
        s = s.replace("{UniqSecond}", "%06dof%06d" % (second, second_dim))
    return s


def run(argv: List[str]) -> int:
    opts = GeneralOptions()
    sso = _SSOptions()
    argv = ["--output-file" if a == "--out" else a for a in argv]
    argv = drop_device(argv)
    compose([opts, sso], argv, positional=["input-file"])

    fn, nf, sd = sso.file_num, sso.num_files, sso.second_dim
    import os
    fifos = []
    if sso.output_fifo:
        for tpl in ([opts.output_file] if opts.output_file else []) + \
                   ([sso.split_file] if sso.split_file else []):
            path = replace_keys(tpl, fn, nf, sd)
            if not os.path.exists(path):
                os.mkfifo(path)
            from kmernator_tpu_torch.utils.cleanup import register_path
            register_path(path)
            fifos.append(path)
    for tpl in sso.extra_fifo:
        path = replace_keys(tpl, fn, nf, sd)
        if not os.path.exists(path):
            os.mkfifo(path)
        from kmernator_tpu_torch.utils.cleanup import register_path
        register_path(path)
        fifos.append(path)
    forked = [subprocess.Popen(replace_keys(c, fn, nf, sd), shell=True)
              for c in sso.fork_command]
    parts = []
    for path in opts.input_file:
        data = open_maybe_gzip(path)
        parts.append(extract_partition(data, fn, nf))
    payload = b"".join(parts)
    if sso.min_read_length > 0 and payload[:1] == b"@":
        recs = payload.split(b"\n")
        kept = []
        for i in range(0, len(recs) - 3, 4):
            if len(recs[i + 1]) >= sso.min_read_length:
                kept.append(b"\n".join(recs[i:i + 4]) + b"\n")
        payload = b"".join(kept)

    if sso.split_file:
        # split interleaved pairs into two outputs (ref: OutputSplitFiles)
        out1 = open(replace_keys(opts.output_file, fn, nf, sd), "wb")
        out2 = open(replace_keys(sso.split_file, fn, nf, sd), "wb")
        recs = payload.split(b"\n")
        i = 0
        which = 0
        while i + 3 < len(recs):
            rec = b"\n".join(recs[i:i + 4]) + b"\n"
            nm, cm, _ = _split_name_line(recs[i][1:], True)
            rn = read_num(nm, cm)
            tgt = out2 if (rn == 2 or (rn == 0 and which == 1)) else out1
            if sso.trim_pair_in_name and rn:
                rec = rec.replace(nm, nm.rsplit(b"/", 1)[0], 1)
            tgt.write(rec)
            which ^= 1
            i += 4
        out1.close()
        out2.close()
    elif sso.pipe_command:
        cmd = replace_keys(sso.pipe_command, fn, nf, sd)
        proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE)
        proc.stdin.write(payload)
        proc.stdin.close()
        proc.wait()
        return proc.returncode
    elif opts.output_file:
        with open(replace_keys(opts.output_file, fn, nf, sd), "wb") as f:
            f.write(payload)
    else:
        sys.stdout.buffer.write(payload)
    rc = 0
    for proc in forked:
        rc = rc or proc.wait()
    # --merge per-rank final: concatenate after forks complete
    # (ref: SplitSequenceOnTheFly.cpp merge list)
    m = [replace_keys(x, fn, nf, sd) for x in sso.merge]
    for src, dst in zip(m[::2], m[1::2]):
        with open(dst, "ab") as out_f, open(src, "rb") as in_f:
            out_f.write(in_f.read())
    if sso.output_fifo:
        for path in fifos:
            try:
                os.unlink(path)
            except OSError:
                pass
    return rc


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
