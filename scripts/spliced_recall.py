#!/usr/bin/env python
"""Junction recall probe at the bench configuration.

Runs the spliced bench workload once and reports how many of the
junction-spanning reads produced a spliced (N-CIGAR) alignment, and how
many of the 64 synthetic junctions appear in junctions.bed — the
sensitivity ground truth the throughput number must not hide.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench


def main():
    from tophat_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    fm = bench.get_fm()
    fm_d = fm.device_put()

    from tophat_tpu.index.fasta import Genome, decode_seq
    from tophat_tpu.io.fastq import batch_reads
    from tophat_tpu.pipeline.params import Params
    from tophat_tpu.pipeline.run import run_pipeline

    codes = np.asarray(fm_d.genome)
    rng = np.random.default_rng(3)
    gt = np.nonzero((codes[:-1] == 2) & (codes[1:] == 3))[0]
    n_junc = 64
    juncs = []
    for s in rng.choice(len(gt) - 1, 4 * n_junc, replace=False):
        d = int(gt[s])
        left = d - 1
        win = codes[d + 100: d + 5000]
        ag = np.nonzero((win[:-1] == 0) & (win[1:] == 2))[0]
        if len(ag) == 0 or left < 200 or d + 5002 >= bench.GENOME_N - 200:
            continue
        right = d + 100 + int(ag[0]) + 2
        juncs.append((left, right))
        if len(juncs) == n_junc:
            break
    genome = Genome(codes=codes, offsets=np.array([0, bench.GENOME_N]),
                    names=["chr1"])
    B = 32768

    r = np.random.default_rng(6)
    recs = []
    spanning = []
    for i in range(B):
        if i % 4 == 0:
            left, right = juncs[int(r.integers(0, len(juncs)))]
            t = int(r.integers(30, 70))
            seq = np.concatenate([codes[left - t + 1:left + 1],
                                  codes[right:right + bench.READ_LEN - t]])
            spanning.append(i)
        else:
            s = int(r.integers(0, bench.GENOME_N - bench.READ_LEN))
            seq = codes[s:s + bench.READ_LEN].copy()
            p = int(r.integers(0, bench.READ_LEN))
            seq[p] = (seq[p] + 1) % 4
        recs.append((f"r{i}", decode_seq(seq), b"I" * bench.READ_LEN))
    batch = batch_reads(recs)

    params = Params(coverage_search=False)
    out_dir = tempfile.mkdtemp(prefix="recall_spliced_")
    t0 = time.time()
    run_pipeline(genome, batch, params, out_dir, fm=fm_d,
                 log=lambda *a: None)
    dt = time.time() - t0
    print(f"# run: {dt:.2f}s = {B/dt:,.0f} reads/s")

    spanning_set = {f"r{i}" for i in spanning}
    spliced_reads = set()
    aligned_reads = set()
    for line in open(os.path.join(out_dir, "accepted_hits.sam")):
        t = line.split("\t")
        aligned_reads.add(t[0])
        if "N" in t[5]:
            spliced_reads.add(t[0])
    bed = [l for l in open(os.path.join(out_dir, "junctions.bed"))
           if not l.startswith("track")]
    found_juncs = set()
    for l in bed:
        f = l.split("\t")
        start = int(f[1])
        sizes = f[10].split(",")
        lj = start + int(sizes[0]) - 1
        found_juncs.add(lj)
    true_juncs = {l for l, rr in juncs}
    print(f"# spanning reads: {len(spanning_set)}, spliced-aligned: "
          f"{len(spliced_reads & spanning_set)} "
          f"({100*len(spliced_reads & spanning_set)/len(spanning_set):.1f}%)")
    print(f"# junctions: {len(true_juncs)} true, {len(bed)} reported, "
          f"{len(found_juncs & true_juncs)} matching")
    print(f"# non-spanning aligned: "
          f"{len(aligned_reads - spanning_set)}/{B - len(spanning_set)}")


if __name__ == "__main__":
    main()
