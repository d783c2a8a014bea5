#!/usr/bin/env python
"""Smoke run of the spliced aligner on NVIDIA GPUs, end to end.

    python chip_smoke.py               # one GPU: phases (a)-(d)
    python chip_smoke.py --four-cards  # four GPUs: only the mesh comparison

Everything is generated from --seed. All device work runs in this one
process, because a second JAX process on a card fails for want of memory;
the CPU side of phase (c) runs in a CPU-only child.

  (a) device: refuse anything but a GPU; print the card's name and power
      limit, JAX's view of it and which native host libraries loaded.
  (b) realignment and the alignment compaction at production widths
      against their plain references (the tests marked `gpu`, run
      in-process through pytest), plus the time of realign_scan.
  (c) a 4 Mbp genome and 4,096 reads through the CLI on the GPU and on the
      CPU: junctions.bed, insertions.bed, deletions.bed and
      accepted_hits.sam must be byte-identical.
  (d) a 134 Mbp genome (2**27 bases in 4 contigs) and 65,536 reads through
      the CLI with its defaults, checked against the planted truth.

--four-cards runs the phase (c) input through the CLI on 1 device, on 4
(reads axis) and on 4 as a 2x2 (reads x genome) mesh; all outputs must be
byte-identical.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failure exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
READ_LEN = 100
COMPARED = ("junctions.bed", "insertions.bed", "deletions.bed",
            "accepted_hits.sam")
# (contig lengths, reads, planted junctions) of phases (c) and (d)
SMALL = ([1 << 21] * 2, 4096, 64)
REAL = ([1 << 25] * 4, 65536, 512)


def say(*a):
    print(*a, flush=True)


def require_gpu(n: int = 1):
    """JAX's devices, or SystemExit unless there are at least n GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise SystemExit(f"chip_smoke: needs {n} GPU(s); JAX found "
                         f"{len(devs)} {devs[0].platform} device(s)")
    return devs


def phase_device(devs):
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        say(f"card: {line}")
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    from tophat_tpu.native import bamenc, bgzf, sais

    for name, lib in (("sais", sais), ("bgzf", bgzf), ("bamenc", bamenc)):
        say(f"native {name}: "
            f"{'loaded' if lib.available else 'FELL BACK to Python'}")
    return smi[0]


# ---------------------------------------------------------------- data --

def make_dataset(out_dir, seed, contig_lens, n_reads, n_junctions):
    """A random genome (FASTA) with n_junctions planted GT-AG introns of
    200-5000 bp, and n_reads 100 bp single-end reads (FASTQ). Every 4th
    read spans a planted intron (overhang 30-70 bp, junctions assigned
    round-robin); the others are genomic with 1-2 mismatches. Half of all
    reads are reverse complements. Returns (fasta, fastq, truth)."""
    from tophat_tpu.index.fasta import decode_seq, revcomp

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"chr{i + 1}" for i in range(len(contig_lens))]
    contigs = [rng.integers(0, 4, n).astype(np.int8) for n in contig_lens]
    junctions = []
    for j in range(n_junctions):
        c = j % len(contigs)
        per = -(-n_junctions // len(contigs))
        slot = len(contigs[c]) // per
        base = (j // len(contigs)) * slot
        d = base + int(rng.integers(200, slot - 5300))    # intron start
        right = d + int(rng.integers(200, 5001))          # first exon base
        contigs[c][d:d + 2] = (2, 3)                      # GT
        contigs[c][right - 2:right] = (0, 2)              # AG
        junctions.append((c, d - 1, right))               # (contig, last, first)
    fa = os.path.join(out_dir, "genome.fa")
    with open(fa, "w") as f:
        for name, codes in zip(names, contigs):
            s = decode_seq(codes)
            f.write(f">{name}\n")
            f.write("\n".join(s[i:i + 60] for i in range(0, len(s), 60)))
            f.write("\n")
    lens = np.array(contig_lens, np.float64)
    spliced, unspliced = {}, {}
    fq = os.path.join(out_dir, "reads.fq")
    qual = "I" * READ_LEN
    with open(fq, "w") as f:
        for i in range(n_reads):
            if i % 4 == 0:
                c, left, right = junctions[(i // 4) % n_junctions]
                t = int(rng.integers(30, 71))
                seq = np.concatenate([contigs[c][left - t + 1:left + 1],
                                      contigs[c][right:right + READ_LEN - t]])
                name = f"j{i}"
                spliced[name] = (names[c], left - t + 1, left, right)
            else:
                c = int(rng.choice(len(contigs), p=lens / lens.sum()))
                p = int(rng.integers(0, contig_lens[c] - READ_LEN))
                seq = contigs[c][p:p + READ_LEN].copy()
                k = int(rng.integers(1, 3))
                at = rng.choice(READ_LEN, k, replace=False)
                seq[at] = (seq[at] + rng.integers(1, 4, k)) % 4
                name = f"u{i}"
                unspliced[name] = (names[c], p)
            if rng.random() < 0.5:
                seq = revcomp(seq)
            f.write(f"@{name}\n{decode_seq(seq)}\n+\n{qual}\n")
    truth = dict(junctions={(names[c], l, r) for c, l, r in junctions},
                 spliced=spliced, unspliced=unspliced)
    return fa, fq, truth


def score(out_dir, truth):
    """(junctions found, junction-read recall, unspliced placement) of a
    CLI output directory against the planted truth."""
    found = set()
    with open(os.path.join(out_dir, "junctions.bed")) as f:
        for line in f:
            if line.startswith("track"):
                continue
            t = line.split("\t")
            start, size0 = int(t[1]), int(t[10].split(",")[0])
            found.add((t[0], start + size0 - 1,
                       start + int(t[11].split(",")[1])))
    hit_j, hit_u = set(), set()
    with open(os.path.join(out_dir, "accepted_hits.sam")) as f:
        for line in f:
            if line.startswith("@"):
                continue
            name, _, chrom, pos, _, cigar = line.split("\t", 6)[:6]
            pos = int(pos) - 1
            if name in truth["unspliced"]:
                if truth["unspliced"][name] == (chrom, pos) and \
                        "N" not in cigar:
                    hit_u.add(name)
            elif name in truth["spliced"] and "N" in cigar:
                ref = pos
                for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
                    if op == "N":
                        break
                    ref += int(n) if op in "MD=X" else 0
                if truth["spliced"][name] == (chrom, pos, ref - 1,
                                              ref + int(n)):
                    hit_j.add(name)
    return (len(found & truth["junctions"]),
            len(hit_j) / len(truth["spliced"]),
            len(hit_u) / len(truth["unspliced"]))


# -------------------------------------------------------------- phases --

def run_cli(fa, fq, out_dir, env=None):
    """tophat_tpu.cli.main in this process, with `env` set around it."""
    from tophat_tpu.cli.main import main
    from tophat_tpu.parallel import auto

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        t0 = time.perf_counter()
        rc = main(["-o", out_dir, fa, fq])
        dt = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        auto.deactivate()
    if rc:
        raise SystemExit(f"chip_smoke: CLI exited {rc} for {out_dir}")
    return dt


def differing_outputs(dir_a, dir_b):
    """Names of the COMPARED files whose bytes differ between two runs."""
    def read(d, n):
        with open(os.path.join(d, n), "rb") as f:
            return f.read()

    return [n for n in COMPARED if read(dir_a, n) != read(dir_b, n)]


def phase_kernels(seed):
    """Time realign_scan at the production shape, then run the tests
    marked `gpu` (bit-exact comparisons at production widths)."""
    import jax
    import jax.numpy as jnp
    import pytest

    from tophat_tpu.ops.events import prepare_inputs, realign_scan

    rng = np.random.default_rng(seed)
    R, E, L = 16384, 128, 100
    genome = jnp.asarray(rng.integers(0, 4, 1 << 20).astype(np.int8))
    reads = rng.integers(0, 4, (R, L)).astype(np.int8)
    lefts = jnp.asarray(rng.integers(L, (1 << 20) - 6000, E), jnp.int32)
    rights = lefts + jnp.asarray(rng.integers(70, 5000, E), jnp.int32)
    X, YL, YC = prepare_inputs(genome, reads, lefts, rights,
                               jnp.zeros(E, jnp.int8),
                               np.full((E, 8), -1, np.int8), 0, L)
    lens = jnp.full(R, L, jnp.int32)
    run = lambda: realign_scan(X, YL, YC, lens, L=L, q=0, max_mm=2)
    jax.block_until_ready(run())
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    say(f"realign_scan R={R} E={E} L={L} q=0: median "
        f"{1e3 * float(np.median(times)):.3f} ms over 10 calls "
        f"(min {1e3 * min(times):.3f})")
    env = dict(os.environ)
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "-p", "no:randomly", os.path.join(ROOT, "tests")])
    finally:
        os.environ.clear()
        os.environ.update(env)
    if rc != 0:
        raise SystemExit(f"chip_smoke: tests marked gpu failed (rc {rc})")
    say("phase b: tests marked gpu passed")


def phase_cpu_vs_gpu(work, seed):
    """Phase (c): the same input through the CLI on the GPU (here) and on
    the CPU (a child with JAX_PLATFORMS=cpu); outputs byte-identical."""
    fa, fq, truth = make_dataset(os.path.join(work, "c"), seed, *SMALL)
    cpu_out = os.path.join(work, "c", "cpu")
    with open(os.path.join(work, "c", "cpu.log"), "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-m", "tophat_tpu.cli.main", "-o", cpu_out, fa,
             fq], cwd=ROOT, stdout=log, stderr=log,
            env=dict(os.environ, JAX_PLATFORMS="cpu",
                     TOPHAT_TPU_DEVICES="1", PYTHONPATH=ROOT))
        try:
            gpu_out = os.path.join(work, "c", "gpu")
            dt = run_cli(fa, fq, gpu_out, env={"TOPHAT_TPU_DEVICES": "1"})
            t0 = time.perf_counter()
            rc = child.wait(timeout=900)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    if rc:
        raise SystemExit(f"chip_smoke: CPU run exited {rc}")
    nj, rec, plc = score(gpu_out, truth)
    say(f"phase c: GPU CLI {dt:.1f} s (cold); CPU child finished "
        f"{time.perf_counter() - t0:.1f} s later; junctions {nj}/"
        f"{len(truth['junctions'])}, junction-read recall {rec:.4f}, "
        f"unspliced placement {plc:.4f}")
    diff = differing_outputs(gpu_out, cpu_out)
    if diff:
        raise SystemExit(f"chip_smoke: GPU and CPU outputs differ: {diff}")
    say(f"phase c: {', '.join(COMPARED)} byte-identical on GPU and CPU")


@contextlib.contextmanager
def timed_calls(module, name, acc):
    """Add the wall time of every call of module.name to acc[0]."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[0] += time.perf_counter() - t0

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_real_size(work, seed, card):
    """Phase (d): 134 Mbp, 65,536 reads, CLI defaults, planted truth."""
    from tophat_tpu.pipeline import chains, run

    t0 = time.perf_counter()
    fa, fq, truth = make_dataset(os.path.join(work, "d"), seed + 1, *REAL)
    n_reads, n_bases = REAL[1], sum(REAL[0])
    say(f"phase d: data generated in {time.perf_counter() - t0:.1f} s")
    realign, build = [0.0], [0.0]
    with timed_calls(run, "realign_events_sparse", realign), \
            timed_calls(chains, "realign_events", realign), \
            timed_calls(run, "build_fm_index", build):
        dt = run_cli(fa, fq, os.path.join(work, "d", "out"))
    nj, rec, plc = score(os.path.join(work, "d", "out"), truth)
    map_s = dt - build[0]
    say(f"phase d (smoke figure, not a benchmark; {card}): {n_reads} reads "
        f"on {n_bases:,} bp in {dt:.1f} s wall = {n_reads / dt:,.0f} "
        f"reads/s, compilation included; index build {build[0]:.1f} s; "
        f"after it {map_s:.1f} s = {n_reads / map_s:,.0f} reads/s")
    say(f"phase d: realignment {realign[0]:.2f} s = "
        f"{100 * realign[0] / dt:.2f}% of the wall time "
        f"({100 * realign[0] / map_s:.2f}% of the part after the index "
        f"build)")
    say(f"phase d: junctions found {nj}/{len(truth['junctions'])}; "
        f"junction-read recall {rec:.6f}; unspliced placed at their origin "
        f"{plc:.6f}")
    if nj != len(truth["junctions"]) or rec < 0.99 or plc < 0.99:
        raise SystemExit("chip_smoke: phase d below its limits (every "
                         "junction, recall >= 0.99, placement >= 0.99)")


def phase_four_cards(work, seed):
    fa, fq, _ = make_dataset(os.path.join(work, "c"), seed, *SMALL)
    runs = (("1", {"TOPHAT_TPU_DEVICES": "1"}),
            ("4", {"TOPHAT_TPU_DEVICES": "4"}),
            ("2x2", {"TOPHAT_TPU_DEVICES": "4",
                     "TOPHAT_TPU_GENOME_SHARDS": "2"}))
    outs = []
    for tag, env in runs:
        out = os.path.join(work, "c", f"mesh{tag}")
        dt = run_cli(fa, fq, out, env=env)
        say(f"four cards: CLI on {tag} device(s) in {dt:.1f} s")
        outs.append(out)
    for out in outs[1:]:
        diff = differing_outputs(outs[0], out)
        if diff:
            raise SystemExit(f"chip_smoke: {out} differs from the 1-device "
                             f"run: {diff}")
    say(f"four cards: {', '.join(COMPARED)} byte-identical on 1, 4 and "
        f"2x2 devices")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 1 / 4 / 2x2-device comparison")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n = 4 if args.four_cards else 1
    devs = require_gpu(n)
    sys.path.insert(0, ROOT)
    from tophat_tpu.utils.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    card = phase_device(devs)
    work = os.path.join(ROOT, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(work, args.seed)
    else:
        phase_kernels(args.seed)
        say(f"phase b done at {time.perf_counter() - t0:.1f} s")
        phase_cpu_vs_gpu(work, args.seed)
        say(f"phase c done at {time.perf_counter() - t0:.1f} s")
        phase_real_size(work, args.seed, card)
        say(f"phase d done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
