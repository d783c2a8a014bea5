"""Pigeonhole aligner vs brute-force all-placements (bowtie -v semantics)."""

import numpy as np
import pytest

from tophat_tpu.index.fasta import genome_from_seqs, revcomp
from tophat_tpu.index.fm import build_fm_index
from tophat_tpu.ops.align import align_reads, pad_reads


def brute_align(codes, read, k):
    """All (pos, strand, mm) placements of read with <= k mismatches."""
    out = []
    n, l = len(codes), len(read)
    for strand, q in ((0, read), (1, revcomp(np.asarray(read, np.int8)))):
        for p in range(n - l + 1):
            w = codes[p:p + l]
            mm = int(np.sum((w != q) | (w >= 4) | (q >= 4)))
            if mm <= k:
                out.append((p, strand, mm))
    return sorted(out, key=lambda x: (x[1], x[0]))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_align_random_vs_brute(rng, k):
    codes = rng.integers(0, 4, 600).astype(np.int8)
    genome = genome_from_seqs([("c", "".join("ACGT"[c] for c in codes))])
    fm = build_fm_index(genome)

    seqs = []
    for i in range(40):
        l = int(rng.integers(15, 31))
        start = int(rng.integers(0, 600 - l))
        q = codes[start:start + l].copy()
        nmut = int(rng.integers(0, k + 2))  # sometimes k+1 (must NOT align)
        for _ in range(nmut):
            p = int(rng.integers(0, l))
            q[p] = (q[p] + int(rng.integers(1, 4))) % 4
        if i % 5 == 0:
            q = revcomp(q).copy()  # reverse-strand read
        seqs.append(q)

    rf, rr, lens = pad_reads(seqs)
    al = align_reads(fm, rf, rr, lens, genome.offsets,
                     max_mismatches=k, hits_per_seed=64, max_alignments=64)

    for i, q in enumerate(seqs):
        exp = brute_align(codes, q, k)
        got = sorted(
            (int(p), int(s), int(m))
            for p, s, m, v in zip(np.asarray(al.pos[i]), np.asarray(al.strand[i]),
                                  np.asarray(al.mm[i]), np.asarray(al.valid[i]))
            if v)
        assert got == exp, f"read {i}: got {got} expected {exp}"
        assert int(al.n_hits[i]) == len(exp)


def test_align_rejects_contig_spanning(rng):
    g = genome_from_seqs([("a", "ACGTACGTACGTACGT"), ("b", "TTTTGGGGCCCCAAAA")])
    fm = build_fm_index(g)
    # a read matching the concatenation boundary exactly must be rejected
    span = g.codes[10:22]
    rf, rr, lens = pad_reads([span])
    al = align_reads(fm, rf, rr, lens, g.offsets, max_mismatches=0,
                     hits_per_seed=16, max_alignments=8)
    assert int(al.n_hits[0]) == 0


def test_align_n_read(rng):
    codes = rng.integers(0, 4, 400).astype(np.int8)
    genome = genome_from_seqs([("c", "".join("ACGT"[c] for c in codes))])
    fm = build_fm_index(genome)
    q = codes[50:70].copy()
    q[3] = 4  # N counts as a mismatch
    rf, rr, lens = pad_reads([q])
    al0 = align_reads(fm, rf, rr, lens, genome.offsets, max_mismatches=0)
    al1 = align_reads(fm, rf, rr, lens, genome.offsets, max_mismatches=1)
    assert int(al0.n_hits[0]) == 0
    got = [int(p) for p, v in zip(np.asarray(al1.pos[0]),
                                  np.asarray(al1.valid[0])) if v]
    assert 50 in got


def test_align_with_sampled_sa(rng):
    codes = rng.integers(0, 4, 800).astype(np.int8)
    genome = genome_from_seqs([("c", "".join("ACGT"[c] for c in codes))])
    fm_full = build_fm_index(genome)
    fm_samp = build_fm_index(genome, sa_rate=8)
    seqs = [codes[s:s + 30].copy() for s in rng.integers(0, 770, 24)]
    rf, rr, lens = pad_reads(seqs)
    a = align_reads(fm_full, rf, rr, lens, genome.offsets, max_mismatches=2)
    b = align_reads(fm_samp, rf, rr, lens, genome.offsets, max_mismatches=2)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))


def test_align_reads_adaptive_repeats():
    """align_reads_adaptive: reads from a high-copy repeat truncate the
    narrow tier and must come back with the wide tier's full placement
    set (equal to a direct wide-budget run)."""
    import numpy as np
    from tophat_tpu.index.fasta import Genome
    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu.ops.align import (align_reads, align_reads_adaptive,
                                      pad_reads)

    rng = np.random.default_rng(21)
    unit = rng.integers(0, 4, 200).astype(np.int8)
    # 24 copies of the repeat unit embedded in random sequence
    parts = []
    for _ in range(24):
        parts.append(rng.integers(0, 4, 500).astype(np.int8))
        parts.append(unit)
    parts.append(rng.integers(0, 4, 500).astype(np.int8))
    codes = np.concatenate(parts)
    genome = Genome(codes=codes, offsets=np.array([0, len(codes)]),
                    names=["chrR"])
    fm = build_fm_index(genome)
    # reads from inside the repeat (multi-mapping) + unique reads
    seqs = [unit[50:110]] * 4 + [codes[200:260], codes[900:960]]
    rf, rr, lens = pad_reads(seqs)
    off = np.array([0, len(codes)], np.int32)
    ad = align_reads_adaptive(fm, rf, rr, lens, off, max_mismatches=2,
                              narrow_hits=8, wide_hits=32)
    wide = align_reads(fm, rf, rr, lens, off, max_mismatches=2,
                       hits_per_seed=32)

    def placements(a, i):
        v = np.asarray(a.valid)[i]
        return set(zip(np.asarray(a.pos)[i][v].tolist(),
                       np.asarray(a.strand)[i][v].tolist()))

    for i in range(len(seqs)):
        assert placements(ad, i) == placements(wide, i)
    # the repeat reads really do have 24 placements
    assert len(placements(ad, 0)) == 24


def _compaction_case(rng, B, W):
    """Lane tables with positions in [2**16, 2**30] (beyond the 11
    significant bits of TF32 and the 16-bit planes of a float product),
    repeated keys and a random valid mask."""
    valid = rng.random((B, W)) < 0.6
    strand = rng.integers(0, 2, (B, W)).astype(np.int32)
    pos = rng.integers(1 << 16, (1 << 30) + 1, (B, W)).astype(np.int32)
    pos[:, 1::9] = pos[:, :1]               # equal keys: order must be stable
    pos[:, -1] = 1 << 30
    mm = rng.integers(0, 3, (B, W)).astype(np.int32)
    return valid, strand, pos, mm


def check_compaction(rng, B, W, width):
    """ops.align's lane compaction against a numpy stable sort."""
    import jax

    from tophat_tpu.ops.align import _sort_lanes

    valid, strand, pos, mm = _compaction_case(rng, B, W)
    inv = (~valid).astype(np.int32)
    got = jax.jit(_sort_lanes, static_argnums=2)(
        [inv, strand, pos], [mm, valid.astype(np.int32)], width)
    order = np.lexsort((pos, strand, inv), axis=1)[:, :width]
    for a, g in zip((inv, strand, pos, mm, valid.astype(np.int32)), got):
        exp = np.take_along_axis(a, order, axis=1)
        exp = np.pad(exp, ((0, 0), (0, width - exp.shape[1])))
        np.testing.assert_array_equal(np.asarray(g), exp)


@pytest.mark.parametrize("width", [16, 96])
def test_compaction_matches_stable_sort(rng, width):
    check_compaction(rng, 64, 64, width)


@pytest.mark.gpu
def test_compaction_matches_stable_sort_full_width(rng):
    """Production width on the card (B=16384 rows of 64 lanes)."""
    check_compaction(rng, 16384, 64, 64)
