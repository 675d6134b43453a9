"""Layered, composable option modules.

The reference composes per-subsystem singleton option modules
(`_XxxOptions : OptionsBaseInterface`, ref: src/Options.h:104-194) that each
contribute flags to one boost::program_options description; apps pick which
modules they compose.  Here each subsystem is a dataclass with reference-
compatible flag spellings; apps compose them into one argparse parser via
`compose()`.  Flag names and defaults mirror the reference so existing
Kmernator command lines keep working:

  GeneralOptions      ref: src/Options.h:325-657
  KmerBaseOptions     ref: src/Kmer.h:130-178
  KmerSpectrumOptions ref: src/KmerSpectrum.h:90-260
  ReadSelectorOptions ref: src/ReadSelector.h:70-204
  FilterArtifactOptions ref: src/FilterKnownOddities.h:71-168
  DuplicateFilterOptions ref: src/DuplicateFragmentFilter.h:60-130

Copied for kmernator_tpu_torch from kmernator_tpu/utils/options.py; it
differs from its source only in its package imports.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


def _bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() not in ("0", "false", "no", "")


@dataclass
class GeneralOptions:
    """ref: src/Options.h:325-657 (_GeneralOptions)."""
    verbose: int = 0
    debug: int = 0
    threads: int = 0  # 0 = all
    input_file: List[str] = field(default_factory=list)
    output_file: str = ""
    format_output: int = 0          # 0 fastq, 1 fasta, 2 fastq unmasked, 3 fasta unmasked
    keep_read_comment: bool = True  # comments preserved by default (GlobalOptions::isCommentStored)
    min_quality_score: int = 3      # quality below this scores as probability 0.0
    fastq_base_quality: int = 33    # expected input base (autodetected)
    fastq_output_base_quality: int = 33
    ignore_quality: bool = False
    mmap_input: bool = False
    batch_size: int = 100000
    temp_dir: str = "/tmp"
    log_file: str = ""
    gathered_logs: int = 0          # buffer logs, emit rank-ordered on rank 0
    build_output_in_memory: int = 0
    keep_temp_dir: str = ""

    FLAGS = {
        "verbose": int, "debug": int, "threads": int,
        "input-file": list, "output-file": str, "format-output": int,
        "keep-read-comment": _bool, "min-quality-score": int,
        "fastq-base-quality": int, "fastq-output-base-quality": int,
        "ignore-quality": _bool, "mmap-input": _bool, "batch-size": int,
        "temp-dir": str, "log-file": str, "gathered-logs": int,
        "build-output-in-memory": int, "keep-temp-dir": str,
    }


@dataclass
class KmerBaseOptions:
    """ref: src/Kmer.h:130-178 (_KmerBaseOptions)."""
    kmer_size: int = 0  # 0 skips kmer calculations

    FLAGS = {"kmer-size": int}


@dataclass
class KmerSpectrumOptions:
    """ref: src/KmerSpectrum.h:90-260 (_KmerSpectrumOptions)."""
    min_kmer_quality: float = 0.10   # minimum quality-adjusted kmer probability
    min_depth: int = 2
    estimated_depth: float = 20.0
    estimated_error_rate: float = 0.35
    variant_sigmas: float = -1.0
    min_variant_kmer_depth: int = 512
    variant_hamming_distance: int = 2
    save_kmer_mmap: int = 0
    load_kmer_mmap: str = ""
    build_partitions: int = 0
    kmer_subsample: int = 0
    periodic_singleton_purge: int = 0
    gc_heat_map: bool = False

    FLAGS = {
        "min-kmer-quality": float, "min-depth": int,
        "estimated-depth": float, "estimated-error-rate": float,
        "estimated-kmer-depth": float, "estimated-kmer-error-rate": float,
        "variant-sigmas": float, "min-variant-kmer-depth": int,
        "variant-edit-distance": int, "variant-edit-disance": int,
        "save-kmer-mmap": int,
        "load-kmer-mmap": str, "build-partitions": int,
        "kmer-subsample": int, "periodic-singleton-purge": int,
        "gc-heat-map": _bool,
    }
    # flag -> attr where the spelling differs.  The reference really does
    # spell it "variant-edit-disance" (ref: src/KmerSpectrum.h:137) — both
    # that exact spelling and the corrected one are accepted.
    ALIASES = {
        "estimated-depth": "estimated_depth",
        "estimated-error-rate": "estimated_error_rate",
        "estimated-kmer-depth": "estimated_depth",
        "estimated-kmer-error-rate": "estimated_error_rate",
        "variant-edit-distance": "variant_hamming_distance",
        "variant-edit-disance": "variant_hamming_distance",
    }


@dataclass
class ReadSelectorOptions:
    """ref: src/ReadSelector.h:70-204 (_ReadSelectorOptions)."""
    max_kmer_output_depth: int = -1
    partition_by_depth: int = -1
    min_passing_in_pair: int = 1
    min_read_length: float = 0.40
    remainder_trim: float = -1.0
    bimodal_sigmas: float = -1.0
    kmer_scoring_type: str = "MAX"      # SUM, MEDIAN, AVG, MIN, MAX
    normalization_method: str = "RANDOM"  # RANDOM, OPTIMAL
    use_logscale_above_max: bool = False
    separate_outputs: bool = True

    FLAGS = {
        "max-kmer-output-depth": int, "partition-by-depth": int,
        "min-passing-in-pair": int, "min-read-length": float,
        "remainder-trim": float, "bimodal-sigmas": float,
        "kmer-scoring-type": str, "normalization-method": str,
        "use-logscale-above-max": _bool, "separate-outputs": _bool,
    }


@dataclass
class FilterArtifactOptions:
    """ref: src/FilterKnownOddities.h:71-168 (_FilterKnownOdditiesOptions)."""
    skip_artifact_filter: bool = False
    artifact_match_length: int = 24
    artifact_edit_distance: int = 2
    build_artifact_edits_in_filter: int = 2
    mask_simple_repeats: bool = False
    phix_output: bool = False
    filter_output: bool = False
    artifact_reference_file: List[str] = field(default_factory=list)

    FLAGS = {
        "skip-artifact-filter": _bool, "artifact-match-length": int,
        "artifact-edit-distance": int, "build-artifact-edits-in-filter": int,
        "mask-simple-repeats": _bool, "phix-output": _bool,
        "filter-output": _bool, "artifact-reference-file": list,
    }


@dataclass
class DuplicateFilterOptions:
    """ref: src/DuplicateFragmentFilter.h:58-150."""
    dedup_mode: int = 0
    dedup_single: bool = False
    dedup_consensus: bool = True
    dedup_edit_distance: int = 0
    dedup_start_offset: int = 0
    dedup_length: int = 24

    FLAGS = {
        "dedup-mode": int, "dedup-single": _bool, "dedup-consensus": _bool,
        "dedup-edit-distance": int, "dedup-start-offset": int,
        "dedup-length": int,
    }


@dataclass
class FilterReadsOptions:
    """App-specific options (ref: apps/FilterReads.h:76-156)."""
    histogram_file: str = ""
    size_history_file: str = ""
    subtract_file: List[str] = field(default_factory=list)
    reference_file: List[str] = field(default_factory=list)

    FLAGS = {
        "histogram-file": str, "size-history-file": str,
        "subtract-file": list, "reference-file": list,
    }


def _attr_for(module, flag: str) -> str:
    aliases = getattr(module, "ALIASES", {})
    if flag in aliases:
        return aliases[flag]
    return flag.replace("-", "_")


def compose(modules: List[object], argv: List[str],
            positional: Optional[List[str]] = None) -> List[object]:
    """Parse argv into the given option module instances (mutated in place).

    `positional` names flags that absorb trailing positional args, mirroring
    the reference's positional_options_description (e.g. FilterReads takes
    positional `kmer-size input-file...`, ref: apps/FilterReads.cpp:68-69).
    """
    parser = argparse.ArgumentParser(add_help=True, allow_abbrev=False)
    flag_owner = {}
    for m in modules:
        for flag, typ in m.FLAGS.items():
            if flag in flag_owner:
                continue
            flag_owner[flag] = m
            attr = _attr_for(m, flag)
            default = getattr(m, attr)
            if typ is list:
                parser.add_argument("--" + flag, action="append", default=None)
            elif typ is _bool:
                parser.add_argument("--" + flag, type=str, default=None)
            else:
                parser.add_argument("--" + flag, type=typ, default=None)
    parser.add_argument("positional", nargs="*")
    ns = parser.parse_args(argv)

    for flag, m in flag_owner.items():
        val = getattr(ns, flag.replace("-", "_"))
        if val is None:
            continue
        attr = _attr_for(m, flag)
        typ = m.FLAGS[flag]
        if typ is _bool:
            val = _bool(val)
        setattr(m, attr, val)

    # distribute positionals
    if positional and ns.positional:
        pos = list(ns.positional)
        for i, flag in enumerate(positional):
            if not pos:
                break
            m = flag_owner[flag]
            attr = _attr_for(m, flag)
            typ = m.FLAGS[flag]
            if i == len(positional) - 1 and typ is list:
                existing = getattr(m, attr)
                setattr(m, attr, (existing or []) + pos)
                pos = []
            else:
                setattr(m, attr, typ(pos.pop(0)) if typ is not list else [pos.pop(0)])
    return modules
