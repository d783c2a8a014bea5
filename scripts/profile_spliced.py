#!/usr/bin/env python
"""Profile the spliced e2e pipeline at the bench configuration.

Runs the same workload as bench.py's bench_spliced (1 Gbp genome, 32768
reads, 25% junction-spanning) once for warmup and once under cProfile,
printing the top cumulative-time entries — host-side attribution of the
stage split (device calls are synchronous at stage boundaries, so host
time  ~ wall time per stage).
"""

import cProfile
import os
import pstats
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

    def make(seed):
        r = np.random.default_rng(seed)
        recs = []
        for i in range(B):
            if i % 4 == 0:
                left, right = juncs[int(r.integers(0, len(juncs)))]
                t = int(r.integers(30, 70))
                seq = np.concatenate([codes[left - t + 1:left + 1],
                                      codes[right:right + bench.READ_LEN - t]])
            else:
                s = int(r.integers(0, bench.GENOME_N - bench.READ_LEN))
                seq = codes[s:s + bench.READ_LEN].copy()
                p = int(r.integers(0, bench.READ_LEN))
                seq[p] = (seq[p] + 1) % 4
            recs.append((f"r{i}", decode_seq(seq), b"I" * bench.READ_LEN))
        return batch_reads(recs)

    params = Params(coverage_search=False)
    t0 = time.time()
    run_pipeline(genome, make(5), params,
                 tempfile.mkdtemp(prefix="prof_spliced_w_"), fm=fm_d,
                 log=lambda *a: None)
    print(f"# warmup (compile) run: {time.time() - t0:.1f}s", flush=True)

    batch = make(6)
    t0 = time.time()
    run_pipeline(genome, batch, params,
                 tempfile.mkdtemp(prefix="prof_spliced_w2_"), fm=fm_d,
                 log=lambda *a: None)
    print(f"# warmup 2 (same-shape compiles): {time.time() - t0:.1f}s",
          flush=True)

    out_dir = tempfile.mkdtemp(prefix="prof_spliced_")
    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    run_pipeline(genome, batch, params, out_dir, fm=fm_d,
                 log=lambda *a: None)
    pr.disable()
    dt = time.time() - t0
    print(f"# steady run: {dt:.2f}s = {B/dt:,.0f} reads/s", flush=True)
    st = pstats.Stats(pr)
    st.sort_stats("cumulative").print_stats(45)


if __name__ == "__main__":
    main()
