"""Candidate-alignment verification: vectorized gather + mismatch count.

Replaces the per-hit verification work Bowtie does internally and the SeqAn
pattern-finding TopHat uses for window scans (reference:
src/segment_juncs.cpp:2390 simpleSplitAlignment uses Myers bit-vector find).
On the device the whole candidate table is verified at once: one genome
gather of shape (B, C, L) plus elementwise compares.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_windows(genome, pos, L: int):
    """genome: (n,) int8; pos: (...,) int32 -> windows (..., L) int8.

    Out-of-range bases read as code 5 (never matches anything, also != N).
    """
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    idx = pos[..., None] + jnp.arange(L, dtype=jnp.int32)
    inb = (idx >= 0) & (idx < n)
    g = genome[jnp.clip(idx, 0, n - 1)]
    return jnp.where(inb, g, jnp.int8(5))


def count_mismatches(window, read, read_len):
    """Mismatches between window (..., L) and read codes (..., L) over the
    first read_len (...,) bases. N (code 4) on either side mismatches, as in
    Bowtie's treatment of ambiguous bases."""
    L = read.shape[-1]
    t = jnp.arange(L, dtype=jnp.int32)
    in_read = t < read_len[..., None]
    mm = (window != read) | (window >= 4) | (read >= 4)
    return jnp.sum(mm & in_read, axis=-1).astype(jnp.int32)


EVEN = 0x55555555


def _pack_even_bits(bits, W):
    """bool (..., L) -> uint32 (..., W): value of position i lands on bit
    2*(i%16) of word i//16 (the 'even' lanes of the 2-bit layout)."""
    B = bits.shape[:-1]
    L = bits.shape[-1]
    padded = jnp.concatenate(
        [bits.astype(jnp.uint32),
         jnp.zeros(B + (W * 16 - L,), jnp.uint32)], axis=-1)
    padded = padded.reshape(B + (W, 16))
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))
    return jnp.sum(padded << shifts, axis=-1, dtype=jnp.uint32)


def pack_reads(codes, lengths):
    """Pack read codes for word-wise verification.

    codes: (B, L) int8, -1 padded, N = 4. Returns
      packed (B, W) uint32 2-bit codes,
      bad_e  (B, W) even-bit mask of N positions (always mismatch),
      len_e  (B, W) even-bit mask of in-read positions,
    with W = ceil(L/16)."""
    B, L = codes.shape
    W = (L + 15) // 16
    c = jnp.clip(codes, 0, 3).astype(jnp.uint32)
    cp = jnp.concatenate([c, jnp.zeros((B, W * 16 - L), jnp.uint32)], axis=1)
    cp = cp.reshape(B, W, 16)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    packed = jnp.sum(cp << shifts, axis=2, dtype=jnp.uint32)
    in_len = jnp.arange(L) < lengths[:, None]
    bad_e = _pack_even_bits(codes >= 4, W)
    len_e = _pack_even_bits(in_len, W)
    return packed, bad_e, len_e


def _expand_1bit_to_even(x16):
    """uint32 with data in low 16 bits -> bits spread to even positions."""
    x = x16 & jnp.uint32(0xFFFF)
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x


def count_mismatches_packed(packed_genome, n_mask, pos, r_packed, bad_e,
                            len_e, L: int, has_n: bool = True,
                            dual_nwp: int = 0):
    """Word-packed replacement for gather_windows + count_mismatches:
    gathers ~L/16 uint32 words per candidate instead of L bytes and counts
    mismatches with XOR + popcount.

    pos: (B, C) candidate window starts. Caller must mask out-of-bounds
    candidates itself (their counts are garbage).

    The word axis is a static python loop, NOT a vectorized trailing dim:
    every intermediate is one (B, C) plane. This was chosen for an earlier
    accelerator whose (8, 128) tiles padded a (B, C, W+1) gather volume
    with W+1 ~ 3 about 300-fold; it is correct on the GPU and is kept
    until it is re-measured there.

    dual_nwp > 0: packed_genome carries the appended 8-shifted copy
    (index/fm.FMIndex.pg_dual, primary region dual_nwp words). When the
    window also satisfies L <= 16*W - 7, the copy whose alignment puts
    pos in the low half of a word is chosen per lane, which drops the
    genome gathers from W+1 to W — the largest single term of the
    segment engine's verify budget."""
    packed_genome = jnp.asarray(packed_genome)
    n_mask = jnp.asarray(n_mask)
    W = r_packed.shape[-1]
    NW = packed_genome.shape[0]

    dual = bool(dual_nwp) and L <= 16 * W - 7
    if dual:
        sel = (pos & 15) >= 8
        eff = jnp.where(sel, pos - 8, pos)
        word0 = jnp.where(sel, dual_nwp + (eff >> 4), eff >> 4)
        sh2 = (eff & 15).astype(jnp.uint32) * 2      # <= 14
    else:
        word0 = pos >> 4
        sh2 = (pos & 15).astype(jnp.uint32) * 2
    rp = r_packed[:, None, :] if r_packed.ndim == 2 else r_packed
    be = bad_e[:, None, :] if bad_e.ndim == 2 else bad_e
    le = len_e[:, None, :] if len_e.ndim == 2 else len_e

    if has_n:
        W1 = (W + 1) // 2 + 1
        NW1 = n_mask.shape[0]
        w0n = pos >> 5
        shn = (pos & 31).astype(jnp.uint32)
        n_words = []
        rawn_next = n_mask[jnp.clip(w0n, 0, NW1 - 1)]
        for j2 in range(W1):
            rawn_cur = rawn_next
            rawn_next = n_mask[jnp.clip(w0n + (j2 + 1), 0, NW1 - 1)]
            lon = rawn_cur >> shn
            hin = jnp.where(shn > 0, rawn_next << (32 - shn),
                            jnp.uint32(0))
            n_words.append(lon | hin)

    total = jnp.zeros(pos.shape, jnp.int32)
    zero32 = jnp.zeros(pos.shape, jnp.uint32)
    raw_next = packed_genome[jnp.clip(word0, 0, NW - 1)]
    for jw in range(W):
        raw_cur = raw_next
        last = dual and jw == W - 1      # dual: word W would cross into
        #                                  the other copy — never needed
        raw_next = zero32 if last else \
            packed_genome[jnp.clip(word0 + (jw + 1), 0, NW - 1)]
        lo = raw_cur >> sh2
        hi = jnp.where(sh2 > 0, raw_next << (32 - sh2), jnp.uint32(0))
        x = (lo | hi) ^ rp[..., jw]
        m2 = (x | (x >> 1)) & jnp.uint32(EVEN)
        if has_n:
            half = n_words[jw // 2] >> jnp.uint32(16 * (jw % 2))
            m2 = m2 | _expand_1bit_to_even(half)
        m = (m2 | be[..., jw]) & le[..., jw]
        total = total + jax.lax.population_count(m).astype(jnp.int32)
    return total


def same_contig(offsets, pos, read_len):
    """True where [pos, pos+read_len) lies inside one contig of the
    concatenated genome (offsets: (num_contigs+1,) int64/int32)."""
    offsets = jnp.asarray(offsets).astype(jnp.int32)
    a = jnp.searchsorted(offsets, pos, side="right")
    b = jnp.searchsorted(offsets, pos + read_len - 1, side="right")
    return a == b
