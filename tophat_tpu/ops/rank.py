"""Batched Occ/rank queries on the packed BWT (the FM-index inner loop).

This is the device-side replacement for Bowtie's Occ-table walk (the hot
kernel TopHat spends its alignment time in via the external `bowtie2`
subprocess, reference: src/tophat.py:2286-2353). Formulated as pure gathers +
popcounts so XLA vectorizes it over a whole read batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tophat_tpu.index.fm import OCC_BLOCK, WORDS_PER_BLOCK


def rank(fm, c, i):
    """#occurrences of code `c` (0..3) in bwt[0:i). Broadcasts over c/i.

    i in [0, n+1]; the sentinel row (fm.primary, stored as code 0) is
    excluded from the count.
    """
    c = jnp.asarray(c, jnp.int32)
    i = jnp.asarray(i, jnp.int32)
    c, i = jnp.broadcast_arrays(c, i)

    occ_ck = jnp.asarray(fm.occ_ck)
    packed_bwt = jnp.asarray(fm.packed_bwt)

    blk = i // OCC_BLOCK
    ck = occ_ck[blk, c]

    occ_mid = jnp.asarray(fm.occ_mid)
    if occ_mid.shape[0] > 0:
        # mid-checkpoint path: 1 byte + 2 words instead of 8 words
        sub = i // 32
        ck = ck + occ_mid[jnp.minimum(sub, occ_mid.shape[0] - 1),
                          c].astype(jnp.int32)
        word0 = sub * 2
        nwords = 2
        j = i - sub * 32  # bases included past the mid-checkpoint, [0, 32]
    else:
        word0 = blk * WORDS_PER_BLOCK
        nwords = WORDS_PER_BLOCK
        j = i - blk * OCC_BLOCK  # bases of this block included

    # 2-bit match-count over the partial span [checkpoint, i)
    widx = word0[..., None] + jnp.arange(nwords, dtype=jnp.int32)
    words = packed_bwt[jnp.minimum(widx, packed_bwt.shape[0] - 1)]

    pat = (c.astype(jnp.uint32) * jnp.uint32(0x55555555))[..., None]
    x = words ^ pat
    m = ~(x | (x >> 1)) & jnp.uint32(0x55555555)  # bit 2k set iff base k == c

    # per-word prefix masks: word w covers bases [w*16, w*16+16) of the span
    covered = jnp.clip(j[..., None] - jnp.arange(nwords) * 16, 0, 16)
    mask = jnp.where(
        covered >= 16,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * covered).astype(jnp.uint32)) - jnp.uint32(1),
    )
    within = jax.lax.population_count(m & mask).sum(axis=-1).astype(jnp.int32)

    sentinel = ((c == 0) & (fm.primary < i)).astype(jnp.int32)
    return ck + within - sentinel


def bwt_symbol(fm, i):
    """Symbol code stored at BWT row i (the sentinel row reads as 0)."""
    i = jnp.asarray(i, jnp.int32)
    word = jnp.asarray(fm.packed_bwt)[i // 16]
    return ((word >> (2 * (i % 16)).astype(jnp.uint32)) & jnp.uint32(3)).astype(jnp.int32)


def lf(fm, i):
    """LF-mapping: row of the predecessor suffix. LF(primary) = 0."""
    c = bwt_symbol(fm, i)
    out = jnp.asarray(fm.C)[c] + rank(fm, c, i)
    return jnp.where(i == fm.primary, 0, out)
