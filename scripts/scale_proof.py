#!/usr/bin/env python
"""Whole-genome scale proof: build and run the contig-group pipeline on a
3.2 Gbp, 24-contig (hg-like contig sizes) genome on one device.

Records index build time, end-to-end reads/s, and per-contig junction
coordinate correctness into .bench_cache/scale_proof.json (+ .log). This
checks the reference's primary operating envelope (hg19 = 3.1 Gbp,
/root/reference/doc/html/manual.shtml:74; index checks src/tophat.py:1282).

Run:  python scripts/scale_proof.py        (~2h first time: 4 SA-IS passes
      per group x 4 groups; group indexes cache under .bench_cache/)
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".bench_cache")

# hg19-like contig ladder (Mbp), 24 contigs, 3.10 Gbp total
CONTIG_MBP = [249, 243, 198, 191, 181, 171, 159, 146, 141, 136, 135, 134,
              115, 107, 103, 90, 81, 78, 59, 63, 48, 51, 155, 59]
READ_LEN = 100
N_READS = 16384   # device memory headroom: the 1.95 Gbp group index is ~6.5 GiB
#                   device-resident; a 16k batch keeps the spliced-stage
#                   grids well inside the remaining budget
N_JUNC_CONTIGS = (0, 11, 23)     # first group, middle, last
JUNCS_PER_CONTIG = 8


def build_genome():
    from tophat_tpu.index.fasta import Genome

    rng = np.random.default_rng(20260821)
    sizes = [m * 1_000_000 for m in CONTIG_MBP]
    total = sum(sizes)
    codes = np.empty(total, np.int8)
    off = 0
    for s in sizes:
        codes[off:off + s] = rng.integers(0, 4, s, dtype=np.int8)
        off += s
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    names = [f"chr{i + 1}" for i in range(len(sizes))]
    genome = Genome(codes=codes, offsets=offsets, names=names)

    # plant GT..AG introns (400 bp) at known per-contig positions
    juncs = {}   # contig -> [(last_exonic_local, first_exonic_local)]
    for ci in N_JUNC_CONTIGS:
        base = int(offsets[ci])
        lst = []
        for k in range(JUNCS_PER_CONTIG):
            a = 1_000_000 + k * 2_000_000          # local intron start
            il = 400
            codes[base + a] = 2
            codes[base + a + 1] = 3
            codes[base + a + il - 2] = 0
            codes[base + a + il - 1] = 2
            lst.append((a - 1, a + il))
        juncs[ci] = lst
    return genome, juncs


def make_reads(genome, juncs, rng):
    from tophat_tpu.index.fasta import decode_seq
    from tophat_tpu.io.fastq import batch_reads

    codes = genome.codes
    offsets = genome.offsets
    nc = len(genome.names)
    recs = []
    expected_spliced = []
    jlist = [(ci, l, r) for ci, lst in juncs.items() for (l, r) in lst]
    for i in range(N_READS):
        if i % 4 == 0:   # junction-spanning
            ci, l, r = jlist[int(rng.integers(0, len(jlist)))]
            base = int(offsets[ci])
            t = int(rng.integers(30, 70))
            seq = np.concatenate(
                [codes[base + l - t + 1: base + l + 1],
                 codes[base + r: base + r + READ_LEN - t]])
            expected_spliced.append(f"r{i}")
        else:
            ci = int(rng.integers(0, nc))
            base = int(offsets[ci])
            clen = int(offsets[ci + 1] - offsets[ci])
            s = int(rng.integers(100, clen - READ_LEN - 100))
            seq = codes[base + s: base + s + READ_LEN].copy()
            p = int(rng.integers(0, READ_LEN))
            seq[p] = (seq[p] + 1) % 4
        recs.append((f"r{i}", decode_seq(seq), b"I" * READ_LEN))
    return batch_reads(recs), expected_spliced


def main():
    import jax

    from tophat_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from tophat_tpu.index.grouped import build_grouped_fm
    from tophat_tpu.pipeline.grouped import run_pipeline_grouped
    from tophat_tpu.pipeline.params import Params

    os.makedirs(CACHE, exist_ok=True)
    logf = open(os.path.join(CACHE, "scale_proof.log"), "w")

    def log(*a):
        msg = " ".join(str(x) for x in a)
        print(msg, flush=True)
        logf.write(msg + "\n")
        logf.flush()

    t0 = time.time()
    genome, juncs = build_genome()
    log(f"genome: {genome.n:,} bases, {len(genome.names)} contigs "
        f"({time.time() - t0:.0f}s to synthesize)")

    t0 = time.time()
    prefix = os.path.join(CACHE, "scale3g")
    cached = os.path.exists(prefix + ".g0.tt.npz")
    gfm = build_grouped_fm(genome, kmer_k=13, sa_rate=4,
                           cache_prefix=prefix, log=log)
    build_s = time.time() - t0
    log(f"grouped index: {gfm.n_groups} groups in {build_s:.0f}s "
        f"({'cache reuse' if cached else 'fresh build'})")

    rng = np.random.default_rng(5)
    batch, expected_spliced = make_reads(genome, juncs, rng)
    out_dir = os.path.join(ROOT, ".bench_cache", "scale3g_out")
    params = Params(coverage_search=False)
    t0 = time.time()
    run_pipeline_grouped(genome, batch, params, out_dir, gfm, log=log)
    wall = time.time() - t0
    log(f"pipeline: {N_READS} reads in {wall:.1f}s = "
        f"{N_READS / wall:,.0f} reads/s (one device, incl. per-group "
        f"index transfers)")

    # ---- validate junction coordinates per contig ----
    found = set()
    for line in open(os.path.join(out_dir, "junctions.bed")):
        if line.startswith("track"):
            continue
        f = line.split("\t")
        chrom, start = f[0], int(f[1])
        sizes = f[10].split(",")
        lj = start + int(sizes[0]) - 1         # last exonic base, 0-based
        found.add((chrom, lj))
    expected = {(genome.names[ci], l) for ci, lst in juncs.items()
                for (l, r) in lst}
    n_match = len(found & expected)
    log(f"junctions: {len(expected)} planted, {len(found)} reported, "
        f"{n_match} matching per-contig coordinates")

    spliced_reads = set()
    aligned = 0
    for line in open(os.path.join(out_dir, "accepted_hits.sam")):
        t = line.split("\t", 6)
        aligned += 1
        if "N" in t[5]:
            spliced_reads.add(t[0])
    recall = 100.0 * len(spliced_reads & set(expected_spliced)) / max(
        1, len(expected_spliced))
    log(f"alignments: {aligned}; junction-read spliced recall "
        f"{recall:.1f}% ({len(spliced_reads & set(expected_spliced))}"
        f"/{len(expected_spliced)})")

    result = dict(
        genome_bases=int(genome.n), n_contigs=len(genome.names),
        n_groups=gfm.n_groups, index_build_s=round(build_s, 1),
        index_cached=bool(cached), reads=N_READS,
        wall_s=round(wall, 1), reads_per_s=round(N_READS / wall, 1),
        junctions_planted=len(expected), junctions_matching=n_match,
        junction_read_recall_pct=round(recall, 1),
        device=jax.devices()[0].device_kind)
    prev = os.path.join(CACHE, "scale_proof.json")
    if cached and os.path.exists(prev):   # keep the fresh-build number
        old = json.load(open(prev))
        if "index_build_fresh_s" in old:
            result["index_build_fresh_s"] = old["index_build_fresh_s"]
        elif not old.get("index_cached", True):
            result["index_build_fresh_s"] = old["index_build_s"]
    else:
        result["index_build_fresh_s"] = round(build_s, 1)
    with open(prev, "w") as f:
        json.dump(result, f, indent=1)
    log(f"{prev} written")
    assert n_match == len(expected), "planted junction coordinates missing"


if __name__ == "__main__":
    main()
