#!/usr/bin/env python
"""Measure beam vs pigeonhole segment mapping at the bench scale (1 Gbp,
65536 x 25bp segment rows) on the device: wall time + planted-hit
recall at several pool factors."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench


def main():
    from tophat_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    fm = bench.get_fm()
    print(f"# index loaded, kmer_k={fm.kmer_k}", flush=True)
    fm_d = fm.device_put()
    codes = np.asarray(fm.genome)
    n = len(codes)
    offsets = np.array([0, n], np.int32)

    B = 65536
    L = 25
    rng = np.random.default_rng(42)
    starts = rng.integers(100, n - 100, B)
    rows = codes[starts[:, None] + np.arange(L)].copy()
    # mismatch classes: 25% clean, 25% 1mm, 25% 2mm same half, 25% 2mm split
    cls = np.arange(B) % 4
    for i in range(B):
        if cls[i] == 1:
            p = rng.integers(0, L)
            rows[i, p] = (rows[i, p] + 1) % 4
        elif cls[i] == 2:
            h = L // 2
            side = rng.integers(0, 2)
            lo, hi = (0, h) if side == 0 else (h, L)
            for p in rng.choice(np.arange(lo, hi), 2, replace=False):
                rows[i, p] = (rows[i, p] + 1) % 4
        elif cls[i] == 3:
            p1 = rng.integers(0, L // 2)
            p2 = rng.integers(L // 2, L)
            rows[i, p1] = (rows[i, p1] + 1) % 4
            rows[i, p2] = (rows[i, p2] + 1) % 4
    rows = rows.astype(np.int8)
    lens = np.full(B, L, np.int32)

    import jax.numpy as jnp

    rows_d = jnp.asarray(rows)
    lens_d = jnp.asarray(lens)

    def recall(pos, valid):
        pos = np.asarray(pos)
        valid = np.asarray(valid)
        hit = ((pos == starts[:, None]) & valid).any(axis=1)
        out = {}
        for c, name in enumerate(("clean", "1mm", "2mm-same", "2mm-split")):
            m = cls == c
            out[name] = 100.0 * hit[m].mean()
        return out

    # pigeonhole baseline
    from tophat_tpu.ops.align import align_forward_rows

    for trial in range(2):
        t0 = time.time()
        out = align_forward_rows(fm_d, rows_d, lens_d, offsets,
                                 max_mismatches=2, hits_per_seed=32,
                                 max_hits=16)
        s = int(np.asarray(out[3]).sum())
        dt = time.time() - t0
    print(f"# pigeonhole: {dt:.2f}s  nhits={s}  recall={recall(out[0], out[2])}",
          flush=True)

    from tophat_tpu.ops import beam

    for trial in range(2):
        t0 = time.time()
        out = beam.beam_align_rows(fm_d, rows_d, lens_d, offsets,
                                   max_mismatches=2, max_hits=16)
        s = int(np.asarray(out[3]).sum())
        dt = time.time() - t0
    tr = int(np.asarray(out[4]).sum())
    print(f"# half-split (auto caps): {dt:.2f}s  nhits={s}  "
          f"overflow_rows={tr}  recall={recall(out[0], out[2])}",
          flush=True)


if __name__ == "__main__":
    main()
