"""apps.count_pass_s: seconds a job spends in its counting pass (apps).

The host clock around the count: FilterReads' `_streaming_mesh_count`
(pass 1 of the streaming --mesh engine: parse, artifact screen, the table
on the card, its finalize) and MeraculousCounter's
`build_extension_spectrum_mesh`. The distributed engine has no function
of its own for pass 1: there the pass runs from the job's start to the
return of the table's last `purge_min_depth` or `finalize`. Per job: the
window's sum over its jobs.
"""
PROBES = [
    dict(name="count_pass", kind="host", targets=[
        "kmernator_tpu_torch.apps.filter_reads:_streaming_mesh_count",
        "kmernator_tpu_torch.apps.meraculous_counter:"
        "build_extension_spectrum_mesh"]),
    dict(name="pass1_end", kind="mark", targets=[
        "kmernator_tpu_torch.parallel.mesh_stream:"
        "MeshStreamingSpectrum.purge_min_depth",
        "kmernator_tpu_torch.parallel.mesh_stream:"
        "MeshStreamingSpectrum.finalize"]),
]


def job_seconds(job):
    p = job["probes"]
    if p.get("count_pass", {}).get("calls"):
        return p["count_pass"]["host_s"]
    marks = p.get("pass1_end", {}).get("marks")
    return max(marks) if marks else None


def value(jobs, ctx):
    secs = [job_seconds(j) for j in jobs]
    if not secs or any(s is None for s in secs):
        return None
    return sum(secs) / len(secs)
