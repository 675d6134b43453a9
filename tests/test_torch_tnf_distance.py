"""kmernator_tpu_torch/apps/tnf_distance.py against the JAX app on seeded
contigs of distinct GC content: the canonical index table and the TNF
vectors exact, and the vectors table byte-identical. Distances come from a
float32 matmul on both sides (torch on the CPU here, jnp.matmul on XLA's
CPU backend in the JAX app), each summing the 136 products in its own
order. Near g = 1 an error e in g moves d = sqrt(2 - 2g) by up to
sqrt(2 e), so every distance is held to BOUND = 4.0e-3, about
sqrt(2 * 136 * 2^-24), and what follows from the distances is held to
the rules that bound allows:
- clusters: a pair whose JAX distance lies within BOUND of the threshold
  may link or not, every other pair links as in JAX;
- the reference-file order: two entries may swap only if their JAX
  distances lie within BOUND of each other;
- the intra-inter histograms: a count may move only across a bin edge
  that its JAX distance lies within BOUND of.
Off the diagonal, where no distance lies near 0, two sound float32 sums
differ by far less than BOUND (0.0 here, about 1e-5 against float64 on a
card); a TF32 product moves them by about 4.6e-3. So the distances off the
diagonal are also held to SOUND = 1.0e-4, which a product of lower
precision would not meet.
SPEARMAN is a float64 numpy product on both sides and must be equal."""
import numpy as np
import pytest
import torch

from kmernator_tpu.apps import tnf_distance as jtnf
from kmernator_tpu.io.reads import load_reads as j_load_reads

from kmernator_tpu_torch.apps import tnf_distance as ttnf
from kmernator_tpu_torch.io.reads import load_reads

BOUND = 4.0e-3
SOUND = 1.0e-4
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _contigs(path, seed, n, gcs, lo=1500, hi=4000, prefix=b"c"):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(n):
            gc = gcs[i % len(gcs)]
            p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
            seq = ACGT[rng.choice(4, int(rng.integers(lo, hi)), p=p)]
            if i % 7 == 3:
                seq[100:140] = ord("N")   # markup windows weigh 0
            f.write(b">%s%03d gc=%.2f\n%s\n" % (prefix, i, gc,
                                                 seq.tobytes()))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tnf")
    fa = str(d / "contigs.fa")
    _contigs(fa, 1, 48, (0.30, 0.42, 0.55, 0.70))
    ref = str(d / "ref.fa")
    _contigs(ref, 2, 3, (0.42,), prefix=b"ref")
    files = [str(d / "gA.fa"), str(d / "gB.fa")]
    _contigs(files[0], 3, 3, (0.35,), 1200, 2000, b"a")
    _contigs(files[1], 4, 3, (0.62,), 1200, 2000, b"b")
    return {"fa": fa, "ref": ref, "files": files, "dir": d}


def _run_both(data, name, extra, inputs=None):
    """Runs both apps; returns {suffix: (port bytes, jax bytes)} for the
    table on --out and each file that `extra` names with a {} pattern."""
    out = {}
    for side, run, dev in (("port", ttnf.run, ["--device", "cpu"]),
                           ("jax", jtnf.run, [])):
        p = str(data["dir"] / ("%s-%s" % (side, name)))
        argv = [a.format(p) for a in extra]
        assert run(dev + argv + ["--out", p + ".vec"]
                   + (inputs or [data["fa"]])) == 0
        for a in extra:
            if "{}" in a:
                out.setdefault(a, []).append(open(a.format(p), "rb").read())
        out.setdefault("table", []).append(open(p + ".vec", "rb").read())
    return out


def _jax_distances(data):
    rs = j_load_reads([data["fa"]])
    tnfs, _ = jtnf.tnf_vectors(rs, 4)
    return tnfs, jtnf.distances(tnfs, "EUCLIDEAN")


def test_canonical_index_table_and_vectors_exact(data):
    for k in (1, 2, 3, 4, 5):
        ti, tu = ttnf.canonical_index_table(k)
        ji, ju = jtnf.canonical_index_table(k)
        assert ti.dtype == ji.dtype and np.array_equal(ti, ji)
        assert tu.dtype == ju.dtype and np.array_equal(tu, ju)
    assert len(ttnf.canonical_index_table(4)[1]) == 136
    rs, jrs = load_reads([data["fa"]]), j_load_reads([data["fa"]])
    for k in (3, 4):
        t, tu = ttnf.tnf_vectors(rs, k)
        j, ju = jtnf.tnf_vectors(jrs, k)
        assert t.dtype == j.dtype == np.float64
        assert np.array_equal(t, j) and np.array_equal(tu, ju)


def test_distances_within_the_bound(data):
    tnfs, dj = _jax_distances(data)
    assert dj.dtype == np.float32       # jnp.matmul in float32 on the CPU
    dt = ttnf.distances(tnfs, "EUCLIDEAN", CPU)
    assert dt.dtype == np.float32 and dt.shape == dj.shape
    diff = np.abs(dt.astype(np.float64) - dj)
    gap = float(diff.max())
    np.fill_diagonal(diff, 0.0)
    off = float(diff.max())
    print("largest |port - JAX| distance gap: %.3e (bound %.1e), off the "
          "diagonal %.3e (limit %.1e)" % (gap, BOUND, off, SOUND))
    assert gap <= BOUND and off <= SOUND
    # the bins exist: contigs of one GC content lie closer than others
    assert dt[0, 4] < dt[0, 1] and dt[1, 5] < dt[1, 2]
    z = np.zeros((3, 136))
    assert np.array_equal(ttnf.distances(z, "EUCLIDEAN", CPU),
                          jtnf.distances(z, "EUCLIDEAN"))


def test_vectors_table_and_inter_distances(data):
    out = _run_both(data, "inter", ["--inter-distance-file", "{}.inter"])
    t, j = out["table"]
    assert t == j and t.startswith(b"Label\tCount\tLength\tAAAA")
    rows_t = [r.split(b"\t") for r in out["{}.inter"][0].splitlines()]
    rows_j = [r.split(b"\t") for r in out["{}.inter"][1].splitlines()]
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    assert [len(r) for r in rows_t] == list(range(1, 49))
    gap = max(abs(float(a) - float(b)) for rt, rj in zip(rows_t, rows_j)
              for a, b in zip(rt[1:], rj[1:]))
    assert gap <= SOUND     # the file holds no diagonal


def _components(n, edges):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x
    for i, j in edges:
        parent[find(i)] = find(j)
    return [find(i) for i in range(n)]


@pytest.mark.parametrize("threshold", ["0.175", "at-a-distance"])
def test_clusters_follow_jax(data, threshold):
    tnfs, dj = _jax_distances(data)
    n = len(dj)
    iu = np.triu_indices(n, 1)
    if threshold == "at-a-distance":   # a pair sits on the threshold
        threshold = "%.9g" % float(np.sort(dj[iu])[n])
    thr = float(threshold)
    out = _run_both(data, "cl" + threshold, [
        "--cluster-threshold-distance", threshold, "--cluster-file",
        "{}.cl"])
    names = [ln.split(b"\t")[0] for ln in out["table"][0].splitlines()[1:]]
    member = {}
    for gid, line in enumerate(out["{}.cl"][0].splitlines()):
        g, name = line.split(b"\t")
        member[names.index(name)] = int(g)
    port = [member[i] for i in range(n)]
    near = np.abs(dj[iu] - thr) <= BOUND
    if not near.any():
        assert out["{}.cl"][0] == out["{}.cl"][1]
    # every port cluster lies between the clusters of the links certain
    # under the bound and those of the links possible under it
    sure = _components(n, [(i, j) for i, j in zip(*iu)
                           if dj[i, j] <= thr - BOUND])
    maybe = _components(n, [(i, j) for i, j in zip(*iu)
                            if dj[i, j] <= thr + BOUND])
    for i, j in zip(*iu):
        if sure[i] == sure[j]:
            assert port[i] == port[j]
        if maybe[i] != maybe[j]:
            assert port[i] != port[j]
    assert 1 < len(set(port)) < n


def test_reference_file_order(data):
    out = _run_both(data, "ref", ["--reference-file", data["ref"]])
    rows = {}
    for side, text in zip(("port", "jax"), out["table"]):
        rows[side] = [(float(r.split("\t")[0]), r.split("\t")[1])
                      for r in text.decode().splitlines()]
    dist_j = {name: d for d, name in rows["jax"]}
    assert sorted(dist_j) == sorted(name for _, name in rows["port"])
    for d, name in rows["port"]:
        assert abs(d - dist_j[name]) <= BOUND
    pos_j = {name: i for i, (_, name) in enumerate(rows["jax"])}
    order = [name for _, name in rows["port"]]
    for a in range(len(order)):
        for b in range(a + 1, len(order)):
            if pos_j[order[a]] > pos_j[order[b]]:   # swapped against JAX
                assert abs(dist_j[order[a]] - dist_j[order[b]]) <= BOUND


@pytest.mark.parametrize("w2", [False, True])
def test_intra_inter_histograms(data, w2):
    extra = ["--intra-inter-file", "{}.ii", "--window-size", "300",
             "--window-step", "150", "--include-intra-inter-data-file", "1",
             "--likelihood-bins", "250"]
    if w2:
        extra += ["--window2-size", "500", "--window2-step", "250"]
    out = _run_both(data, "ii%d" % w2, extra, inputs=data["files"])
    dt, dj = [], []
    for side, acc in (("port", dt), ("jax", dj)):
        p = str(data["dir"] / ("%s-ii%d.ii.data" % (side, w2)))
        acc += [ln.split("\t") for ln in open(p).read().splitlines()]
    assert [c for c, _ in dt] == [c for c, _ in dj]
    vt = np.array([float(v) for _, v in dt])
    vj = np.array([float(v) for _, v in dj])
    assert np.abs(vt - vj).max() <= BOUND
    ht = np.array([r.split("\t") for r in out["{}.ii"][0].decode()
                   .splitlines()[1:]], float)
    hj = np.array([r.split("\t") for r in out["{}.ii"][1].decode()
                   .splitlines()[1:]], float)
    assert np.array_equal(ht[:, 0], hj[:, 0])          # bin starts
    assert np.array_equal(ht.sum(axis=0)[1:], hj.sum(axis=0)[1:])
    names = ["intra", "inter", "intra_vs_whole", "inter_vs_whole"]
    names += ["intra_w1w2", "inter_w1w2"] if w2 else []
    assert ht.shape[1] == 1 + len(names)
    cats = np.array([c for c, _ in dj])
    edges = hj[1:, 0]
    for col, name in enumerate(names, start=1):
        d = vj[cats == name]
        moved = np.abs(np.cumsum(ht[:, col]) - np.cumsum(hj[:, col]))[:-1]
        # 1e-5: the data file's %g rounding of each JAX distance
        near = [(np.abs(d - e) <= BOUND + 1e-5).sum() for e in edges]
        assert (moved <= near).all(), name
    assert ht[:, 1].sum() > 0 and ht[:, 2].sum() > 0


def test_spearman_equal(data):
    tnfs, _ = _jax_distances(data)
    assert np.array_equal(ttnf.distances(tnfs, "SPEARMAN", CPU),
                          jtnf.distances(tnfs, "SPEARMAN"))
    out = _run_both(data, "sp", ["--distance-formula", "SPEARMAN",
                                 "--inter-distance-file", "{}.inter"])
    assert out["{}.inter"][0] == out["{}.inter"][1]


def test_cuda_without_a_card_and_tf32_refused(data):
    tnfs, _ = _jax_distances(data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttnf.run(["--inter-distance-file", str(data["dir"] / "x"),
                      data["fa"]])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttnf.run(["--device", "cuda", data["fa"]])
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="without TF32"):
            ttnf.distances(tnfs, "EUCLIDEAN", CPU)
    finally:
        torch.set_float32_matmul_precision(before)
    assert ttnf.distances(tnfs, "EUCLIDEAN", CPU).dtype == np.float32
