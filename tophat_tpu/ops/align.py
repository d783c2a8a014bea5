"""End-to-end unspliced read alignment: pigeonhole seeding + verification.

Bowtie1's `-v <k>` mode (align the whole read with <= k mismatches, report
all placements — the contract TopHat relies on for genome and segment mapping,
reference: src/tophat.py:2339-2344) reimplemented without backtracking so it
jits: split each read into k+1 pieces; any <=k-mismatch alignment leaves at
least one piece exact (pigeonhole), so exact-FM-search every piece, turn piece
hits into candidate read placements, and verify all candidates with one
batched genome gather. Reverse-strand placements come from running the same
machinery on the reverse-complemented reads against the same forward index.

All shapes are static: B reads x (k+1) pieces x H hits/piece candidates ->
(B, M) alignment slots with validity masks.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tophat_tpu.ops.search import backward_search, resolve_sa
from tophat_tpu.ops.verify import (count_mismatches_packed, pack_reads,
                                   same_contig)

# sentinel sort key for invalid candidates (host int: creating a device
# array at import time would trigger backend init for CLI paths that
# never touch the device, e.g. --transcriptome-index build-only)
NEG = np.int32(2**30)


def _sort_lanes(keys, values, width: int):
    """Stable row-wise lexicographic sort: reorder each row's lanes by
    `keys` (list of (B, W) int32, most significant first; equal keys keep
    their lane order), carrying `values` along. Returns the sorted keys
    and values, cut or zero-padded to `width` lanes. Integer data moves
    untouched, so the result is exact for any int32 content (a float
    one-hot product is not: TF32 keeps 11 significant bits)."""
    out = jax.lax.sort(tuple(keys) + tuple(values), dimension=1,
                       is_stable=True, num_keys=len(keys))
    W = keys[0].shape[1]
    if W >= width:
        return [a[:, :width] for a in out]
    return [jnp.pad(a, ((0, 0), (0, width - W))) for a in out]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Alignments:
    """Fixed-width per-read alignment table (struct of arrays).

    The device-side analog of HitsForRead (reference: src/bwt_map.h:1033): all
    placements of read b live in row b, valid ones flagged by `valid`.
    pos is a 0-based global genome coordinate of the leftmost aligned base;
    strand 0 = forward, 1 = reverse complement.
    """

    pos: Any      # int32 (B, M)
    strand: Any   # int8  (B, M)
    mm: Any       # int8  (B, M) mismatch count
    valid: Any    # bool  (B, M)
    n_hits: Any   # int32 (B,) total valid placements (pre-truncation)
    truncated: Any  # bool (B,) seed-hit cap hit; counts may be lower bounds

    @property
    def shape(self):
        return self.pos.shape


def _piece_queries(reads, lengths, num_pieces: int, piece_len: int):
    """Cut each read into num_pieces contiguous pieces, right-aligned into a
    (B, num_pieces, piece_len) query array padded with -1; also return piece
    start offsets (B, num_pieces)."""
    B, L = reads.shape
    j = jnp.arange(num_pieces, dtype=jnp.int32)
    s = (j[None, :] * lengths[:, None]) // num_pieces          # (B, P)
    e = ((j[None, :] + 1) * lengths[:, None]) // num_pieces
    plen = e - s
    t = jnp.arange(piece_len, dtype=jnp.int32)
    src = s[:, :, None] + t[None, None, :] - (piece_len - plen)[:, :, None]
    ok = src >= s[:, :, None]
    b_idx = jnp.arange(B, dtype=jnp.int32)[:, None, None]
    q = reads[b_idx, jnp.clip(src, 0, L - 1)]
    return jnp.where(ok, q, jnp.int8(-1)).astype(jnp.int32), s, plen


def _fast_seed_intervals(fm, reads, lengths, P: int, span: int,
                         uniform_len: int = 0):
    """SA intervals for the last `span` characters of each of the P
    pigeonhole pieces, via the k-mer table. Requires span >= k and every
    piece length >= span (kmer_fast_ok).

    uniform_len: static read length when every row has it (the common
    case) — piece boundaries become compile-time constants, so the key
    bases come from plain slices instead of a row-wise gather.

    Returns (lo, hi, cand_base): (B, P) interval bounds and the candidate
    read-start offset base (piece_end - span)."""
    k = fm.kmer_k
    B, L = reads.shape
    j = jnp.arange(1, P + 1, dtype=jnp.int32)
    if uniform_len:
        e_host = [(jj * uniform_len) // P for jj in range(1, P + 1)]
        s_host = [(jj * uniform_len) // P for jj in range(P)]
        e = jnp.asarray(e_host, jnp.int32)[None, :]
        s = jnp.asarray(s_host, jnp.int32)[None, :]
        cols_np = np.array([[ee - 1 - t for t in range(k)]
                            for ee in e_host])               # (P, k)
        x = reads[:, jnp.asarray(np.clip(cols_np.reshape(-1), 0, L - 1))]
        x = x.reshape(B, P, k).astype(jnp.int32)
        cols = jnp.asarray(cols_np, jnp.int32)[None]
    else:
        e = (j[None, :] * lengths[:, None]) // P      # piece ends (B, P)
        s = ((j - 1)[None, :] * lengths[:, None]) // P
        # one fused (B, P*k) gather instead of k row-wise gathers
        t_off = jnp.arange(k, dtype=jnp.int32)
        cols = (e[:, :, None] - 1 - t_off[None, None, :])    # (B, P, k)
        x = jnp.take_along_axis(
            reads, jnp.clip(cols, 0, L - 1).reshape(B, P * k), axis=1
        ).reshape(B, P, k).astype(jnp.int32)
    pw = (4 ** jnp.arange(k, dtype=jnp.int32)).astype(jnp.int32)
    key_e = jnp.sum(jnp.clip(x, 0, 3) * pw[None, None, :], axis=2)
    kok = jnp.all((x >= 0) & (x <= 3) & (cols >= 0), axis=2)
    ok = kok & (e - s >= span) & (e >= span)
    lo = jnp.where(ok, jnp.asarray(fm.kmer_lo)[key_e], 0)
    hi = jnp.where(ok, jnp.asarray(fm.kmer_hi)[key_e], 0)
    if span > k:
        # extend the table interval by the span-k characters preceding the
        # k-mer window (backward search continues leftward)
        from tophat_tpu.ops.rank import rank

        C = jnp.asarray(fm.C)
        b_idx = jnp.arange(B, dtype=jnp.int32)[:, None]
        for t in range(span - k):
            if uniform_len:
                cst = [max(min((jj * uniform_len) // P - k - 1 - t, L - 1),
                           0) for jj in range(1, P + 1)]
                c = reads[:, jnp.asarray(cst, jnp.int32)].astype(jnp.int32)
            else:
                col = jnp.clip(e - k - 1 - t, 0, L - 1)
                c = reads[b_idx, col].astype(jnp.int32)
            is_n = c > 3
            do = (c >= 0) & ~is_n & (lo < hi)
            cc = jnp.clip(c, 0, 3)
            nlo = jnp.where(do, C[cc] + rank(fm, cc, lo), lo)
            nhi = jnp.where(do, C[cc] + rank(fm, cc, hi), hi)
            hi = jnp.where(is_n, nlo, nhi)
            lo = nlo
    return lo, hi, e - span


def seed_span(fm, max_mismatches: int, read_len: int):
    """Width of the shortened seed search (see _align_one_strand)."""
    P = max_mismatches + 1
    piece_len = (read_len + P - 1) // P + 1
    k = getattr(fm, "kmer_k", 0)
    if not k:
        return piece_len
    extend = max(0, math.ceil(math.log(max(4 * fm.n, 4), 4)) - k)
    return min(piece_len, k + extend)


def kmer_fast_ok(fm, min_read_len: int, max_mismatches: int) -> bool:
    """True when seed shortening is complete for every read length >=
    min_read_len: the shortest piece (floor(len/P)) must still cover the
    shortened span, otherwise short pieces pad into the k-mer window and
    would silently lose their seeds."""
    k = getattr(fm, "kmer_k", 0)
    if not k:
        return False
    P = max_mismatches + 1
    extend = max(0, math.ceil(math.log(max(4 * fm.n, 4), 4)) - k)
    return (min_read_len // P) >= k + extend


def _align_one_strand(fm, reads, lengths, max_mismatches: int,
                      hits_per_seed: int, verify_slots: int = 32,
                      kmer_fast: bool = False, resolve_cap: int = 0,
                      uniform_len: int = 0):
    """All placements of `reads` on the forward text with <= max_mismatches.

    Candidates are compacted to `verify_slots` per read before mismatch
    counting, and verification uses the word-packed genome (XOR+popcount
    over uint32 gathers) instead of per-base gathers — the two changes that
    cut the memory traffic of this gather-bound stage.

    Returns (cand_pos, cand_mm, cand_valid, truncated), (B, verify_slots).
    """
    B, L = reads.shape
    P = max_mismatches + 1
    piece_len = (L + P - 1) // P + 1

    # seed shortening: an exact piece implies an exact k-mer suffix of that
    # piece, so searching only the last `span` piece characters preserves
    # pigeonhole completeness — verification rejects the extra candidates.
    # span is sized so expected spurious hits stay O(1) per seed. Callers
    # must enable this only when kmer_fast_ok holds for the batch's minimum
    # read length (shorter pieces would pad into the k-mer window).
    if kmer_fast:
        # rolling-key path: no per-element piece gather at all
        span = seed_span(fm, max_mismatches, L)
        lo, hi, cand_base = _fast_seed_intervals(fm, reads, lengths, P,
                                                 span,
                                                 uniform_len=uniform_len)
    else:
        span = piece_len
        q, piece_start, plen = _piece_queries(reads, lengths, P, piece_len)
        lo, hi = backward_search(fm, q[:, :, piece_len - span:]
                                 .reshape(B * P, span))
        lo = lo.reshape(B, P)
        hi = hi.reshape(B, P)
        cand_base = piece_start + jnp.maximum(plen - span, 0)
    truncated = jnp.any((hi - lo) > hits_per_seed, axis=1)

    h = jnp.arange(hits_per_seed, dtype=jnp.int32)
    idx = lo[:, :, None] + h[None, None, :]                    # (B, P, H)
    seed_valid = idx < hi[:, :, None]
    if resolve_cap and resolve_cap * B * P < B * P * hits_per_seed:
        # compact valid SA rows before the (sampled-SA) LF walk: most seeds
        # have interval width 1, so walking every (read, piece, slot) lane
        # wastes ~90% of the gather traffic. Reads whose lanes overflow the
        # cap are flagged truncated — the adaptive wide tier re-runs them
        # uncompacted (align_reads_adaptive).
        K = B * P * resolve_cap
        flat_idx = idx.reshape(-1)
        flat_valid = seed_valid.reshape(-1)
        csum = jnp.cumsum(flat_valid.astype(jnp.int32))
        keep = flat_valid & (csum <= K)
        dropped = (flat_valid & ~keep).reshape(B, -1).any(axis=1)
        truncated |= dropped
        # slot each kept lane at its prefix-count position (no argsort)
        slot = jnp.where(keep, csum - 1, K)
        sel = jnp.zeros(K + 1, jnp.int32).at[slot].set(flat_idx)[:K]
        pos_k = resolve_sa(fm, sel)
        hitpos = jnp.where(
            keep, jnp.concatenate([pos_k, jnp.zeros(1, jnp.int32)])[
                jnp.minimum(slot, K)], 0).reshape(B, P, hits_per_seed)
        seed_valid = keep.reshape(B, P, hits_per_seed)
    else:
        hitpos = resolve_sa(fm, idx)
    # searched substring starts cand_base into the read
    cand = hitpos - cand_base[:, :, None]                      # read start
    W = P * hits_per_seed
    cand = jnp.where(seed_valid, cand, -NEG).reshape(B, W)

    # dedup identical candidate positions (several pieces exact at same
    # spot): all-pairs keep-first — no row sort needed
    eqmat = cand[:, :, None] == cand[:, None, :]
    dup = (eqmat & jnp.tril(jnp.ones((W, W), bool), -1)[None]).any(axis=2)
    prevalid = (cand != -NEG) & ~dup & (cand >= 0)
    truncated |= prevalid.sum(axis=1) > verify_slots

    r_packed, bad_e, len_e = pack_reads(reads, lengths)
    has_n = getattr(fm, "has_n", True)
    if resolve_cap:
        # flat-compact candidates across the batch before verification:
        # most reads carry 1-3 candidates, so verifying all W slots wastes
        # ~6x of the two hottest gathers (the packed-genome window fetch).
        # Rows whose candidates overflow the cap re-run in the wide tier.
        KV = B * max(resolve_cap * 2, 4)
        flatv = prevalid.reshape(-1)
        flatc = cand.reshape(-1)
        csum = jnp.cumsum(flatv.astype(jnp.int32))
        keep2 = flatv & (csum <= KV)
        truncated |= (flatv & ~keep2).reshape(B, W).any(axis=1)
        slot = jnp.where(keep2, csum - 1, KV)
        sel_pos = jnp.zeros(KV + 1, jnp.int32).at[slot].set(flatc)[:KV]
        rows = jnp.broadcast_to(
            jnp.arange(B, dtype=jnp.int32)[:, None], (B, W)).reshape(-1)
        sel_row = jnp.zeros(KV + 1, jnp.int32).at[slot].set(rows)[:KV]
        dn = ((fm.n + 15) // 16) if getattr(fm, "pg_dual", False) else 0
        mm_k = count_mismatches_packed(
            fm.packed_genome, fm.n_mask, sel_pos[None, :],
            jnp.take(r_packed, sel_row, axis=0)[None],
            jnp.take(bad_e, sel_row, axis=0)[None],
            jnp.take(len_e, sel_row, axis=0)[None], L, has_n=has_n,
            dual_nwp=dn)[0]
        big = jnp.int32(127)
        mm = jnp.where(
            keep2, jnp.concatenate([mm_k, jnp.full(1, big, jnp.int32)])[
                jnp.minimum(slot, KV)], big).reshape(B, W)
        cand_valid = keep2.reshape(B, W)
    else:
        dn = ((fm.n + 15) // 16) if getattr(fm, "pg_dual", False) else 0
        mm = count_mismatches_packed(fm.packed_genome, fm.n_mask, cand,
                                     r_packed, bad_e, len_e, L,
                                     has_n=has_n, dual_nwp=dn)
        cand_valid = prevalid
    cand_valid &= (mm <= max_mismatches) & (cand + lengths[:, None] <= fm.n)
    return cand, mm.astype(jnp.int32), cand_valid, truncated


def _align_batch_core(fm, reads_f, reads_r, lengths, offsets, *,
                      max_mismatches: int, hits_per_seed: int,
                      max_alignments: int, kmer_fast: bool,
                      resolve_cap: int, uniform_len: int) -> Alignments:
    """Align a batch both strands; reads_r must be revcomp(reads_f) with the
    same per-read lengths (padding handled by the caller: both arrays are
    LEFT-aligned code arrays padded with -1).

    offsets: contig offset table (num_contigs+1,) — alignments crossing a
    contig boundary in the concatenated genome are rejected.
    """
    # both strands in ONE stacked pass: every per-op cost (walk loop,
    # gathers, compactions) is paid once over 2B rows instead of twice
    B0 = reads_f.shape[0]
    reads2 = jnp.concatenate([reads_f, reads_r], axis=0)
    len2 = jnp.concatenate([lengths, lengths], axis=0)
    p2, m2, v2, t2 = _align_one_strand(fm, reads2, len2, max_mismatches,
                                       hits_per_seed, kmer_fast=kmer_fast,
                                       resolve_cap=resolve_cap,
                                       uniform_len=uniform_len)
    pf, pr = p2[:B0], p2[B0:]
    mf, mr = m2[:B0], m2[B0:]
    vf, vr = v2[:B0], v2[B0:]
    tf, tr = t2[:B0], t2[B0:]
    pos = jnp.concatenate([pf, pr], axis=1)
    mm = jnp.concatenate([mf, mr], axis=1)
    valid = jnp.concatenate([vf, vr], axis=1)
    strand = jnp.concatenate(
        [jnp.zeros_like(mf, jnp.int8), jnp.ones_like(mr, jnp.int8)], axis=1)

    valid &= same_contig(offsets, pos, lengths[:, None])
    n_hits = valid.sum(axis=1).astype(jnp.int32)

    # compact: valid slots first, ordered by (strand, pos)
    _, strand_s, pos_s, mm_s, valid_s = _sort_lanes(
        [(~valid).astype(jnp.int32), strand.astype(jnp.int32), pos],
        [mm.astype(jnp.int32), valid.astype(jnp.int32)], max_alignments)
    return Alignments(
        pos=pos_s, strand=strand_s.astype(jnp.int8),
        mm=mm_s.astype(jnp.int8), valid=valid_s.astype(bool),
        n_hits=n_hits, truncated=tf | tr)


@partial(jax.jit, static_argnames=("max_mismatches", "hits_per_seed",
                                   "max_alignments", "kmer_fast",
                                   "resolve_cap", "uniform_len"))
def _align_reads_jit(fm, reads_f, reads_r, lengths, offsets, *,
                     max_mismatches: int = 2, hits_per_seed: int = 32,
                     max_alignments: int = 64,
                     kmer_fast: bool = False,
                     resolve_cap: int = 0,
                     uniform_len: int = 0) -> Alignments:
    return _align_batch_core(
        fm, reads_f, reads_r, lengths, offsets,
        max_mismatches=max_mismatches, hits_per_seed=hits_per_seed,
        max_alignments=max_alignments, kmer_fast=kmer_fast,
        resolve_cap=resolve_cap, uniform_len=uniform_len)


@partial(jax.jit, static_argnames=("max_mismatches", "narrow_hits",
                                   "wide_hits", "max_alignments",
                                   "kmer_fast", "resolve_cap",
                                   "uniform_len", "wide_budget"))
def _align_adaptive_jit(fm, reads_f, reads_r, lengths, offsets, *,
                        max_mismatches: int, narrow_hits: int,
                        wide_hits: int, max_alignments: int,
                        kmer_fast: bool, resolve_cap: int,
                        uniform_len: int, wide_budget: int) -> Alignments:
    """Both adaptive tiers in ONE device program: narrow pass over the
    whole batch, then an in-program wide re-run for up to `wide_budget`
    truncated reads (gather rows -> wide search -> scatter results back).
    No host sync between the tiers — the per-batch truncation check that
    capped the driver-visible bench (VERDICT r2 item 6) is gone. Reads
    truncated beyond the budget keep their truncated flag; the host wrapper
    re-runs those rare rows when the caller needs exact hit sets."""
    al = _align_batch_core(
        fm, reads_f, reads_r, lengths, offsets,
        max_mismatches=max_mismatches, hits_per_seed=narrow_hits,
        max_alignments=max_alignments, kmer_fast=kmer_fast,
        resolve_cap=resolve_cap, uniform_len=uniform_len)
    B = reads_f.shape[0]
    RW = wide_budget
    trunc = al.truncated
    csum = jnp.cumsum(trunc.astype(jnp.int32))
    sel = trunc & (csum <= RW)
    overflow = trunc & ~sel                      # host fallback territory
    slot = jnp.where(sel, csum - 1, RW)
    idx_sel = jnp.full(RW + 1, B, jnp.int32).at[slot].set(
        jnp.arange(B, dtype=jnp.int32))[:RW]     # unused slots -> B (drop)

    def wide_pass(_):
        take = lambda a, fill: jnp.concatenate(
            [a, jnp.full((1,) + a.shape[1:], fill, a.dtype)])[
            jnp.minimum(idx_sel, B)]
        alw = _align_batch_core(
            fm, take(reads_f, -1), take(reads_r, -1), take(lengths, 0),
            offsets, max_mismatches=max_mismatches,
            hits_per_seed=wide_hits, max_alignments=max_alignments,
            kmer_fast=kmer_fast, resolve_cap=0, uniform_len=0)
        scat = lambda dst, src: dst.at[idx_sel].set(src, mode="drop")
        return Alignments(
            pos=scat(al.pos, alw.pos),
            strand=scat(al.strand, alw.strand),
            mm=scat(al.mm, alw.mm),
            valid=scat(al.valid, alw.valid),
            n_hits=scat(al.n_hits, alw.n_hits),
            truncated=scat(jnp.where(overflow, True, False),
                           alw.truncated))

    # the wide tier only executes when some read actually truncated —
    # lax.cond compiles both branches but runs one, so clean batches pay
    # nothing beyond the narrow pass (and still no host sync)
    return jax.lax.cond(trunc.any(), wide_pass, lambda _: al, None)


def align_reads(fm, reads_f, reads_r, lengths, offsets, *,
                max_mismatches: int = 2, hits_per_seed: int = 32,
                max_alignments: int = 64,
                kmer_fast: bool = False, resolve_cap: int = 0,
                uniform_len: int = 0) -> Alignments:
    """align (see _align_reads_jit); with an active multi-device mesh
    (parallel/auto.py) the batch is sharded over the reads axis and runs
    SPMD — the analog of the reference's per-thread read ranges
    (src/utils.cpp:22)."""
    from tophat_tpu.parallel import auto

    kw = dict(max_mismatches=max_mismatches, hits_per_seed=hits_per_seed,
              max_alignments=max_alignments, kmer_fast=kmer_fast,
              resolve_cap=resolve_cap, uniform_len=uniform_len)
    if auto.active() is None:
        return _align_reads_jit(fm, reads_f, reads_r, lengths, offsets, **kw)
    if auto.genome_sharded(fm):
        # index over-budget for replication: range-sharded sub-indexes on
        # the mesh's genome axis, exact merge via all_gather (shard_fm.py)
        return auto.sharded_align(reads_f, reads_r, lengths, offsets, **kw)
    (rf, rr, ln), B = auto.shard_rows(reads_f, reads_r, lengths)
    out = _align_reads_jit(auto.replicated(fm), rf, rr, ln,
                           auto.replicated(offsets), **kw)
    return Alignments(pos=out.pos[:B], strand=out.strand[:B], mm=out.mm[:B],
                      valid=out.valid[:B], n_hits=out.n_hits[:B],
                      truncated=out.truncated[:B])


@partial(jax.jit, static_argnames=("max_mismatches", "hits_per_seed",
                                   "max_hits"))
def _align_forward_rows_jit(fm, reads, lengths, offsets, *,
                            max_mismatches: int, hits_per_seed: int,
                            max_hits: int):
    cand, mm, valid, trunc = _align_one_strand(
        fm, reads, lengths, max_mismatches, hits_per_seed)
    valid &= same_contig(offsets, cand, lengths[:, None])
    n_hits = valid.sum(axis=1).astype(jnp.int32)
    _, pos_s, mm_s, valid_s = _sort_lanes(
        [(~valid).astype(jnp.int32), cand],
        [mm.astype(jnp.int32), valid.astype(jnp.int32)], max_hits)
    return (pos_s, mm_s.astype(jnp.int8), valid_s.astype(bool), n_hits,
            trunc)


def align_forward_rows(fm, reads, lengths, offsets, *, max_mismatches: int,
                       hits_per_seed: int, max_hits: int):
    """Forward-text-only variant for rows that are already in genome space
    (segment mapping: the caller supplies revcomp rows itself). Returns
    (pos, mm, valid) compacted to (N, max_hits) plus n_hits and truncation.
    Row-sharded over the active mesh (parallel/auto.py), if any.
    """
    from tophat_tpu.parallel import auto

    kw = dict(max_mismatches=max_mismatches, hits_per_seed=hits_per_seed,
              max_hits=max_hits)
    if auto.active() is None:
        return _align_forward_rows_jit(fm, reads, lengths, offsets, **kw)
    if auto.genome_sharded(fm):
        return auto.sharded_align_rows(reads, lengths, offsets, **kw)
    (rd, ln), B = auto.shard_rows(reads, lengths)
    out = _align_forward_rows_jit(auto.replicated(fm), rd, ln,
                                  auto.replicated(offsets), **kw)
    return tuple(a[:B] for a in out)


def align_reads_adaptive(fm, reads_f, reads_r, lengths, offsets, *,
                         max_mismatches: int = 2, max_alignments: int = 64,
                         kmer_fast: bool = False,
                         narrow_hits: int = 8,
                         wide_hits: int = 32,
                         resolve_cap: int = 1,
                         uniform_len: int = 0,
                         wide_budget: int = 0,
                         defer: bool = False) -> Alignments:
    """Two-tier alignment: a narrow seed-hit budget + compacted SA walk for
    the batch (cheap — most reads have O(1) placements), then a wide
    uncompacted re-run for only the rows whose seeds truncated or whose
    walk lanes overflowed the cap (repeat-family reads). Matches
    align_reads with hits_per_seed=wide_hits on every read, at close to
    narrow-budget cost.

    Both tiers run inside ONE device program (_align_adaptive_jit): the
    wide re-run gathers up to `wide_budget` truncated reads in-program, so
    no host sync separates the tiers. Only reads truncated BEYOND the
    budget fall back to a host-side re-run — with defer=True even that
    check is skipped and the caller receives the device result as-is
    (overflow rows keep their truncated flag), letting pipelined callers
    dispatch batches back-to-back with a single final sync.
    """
    from tophat_tpu.parallel import auto

    B = reads_f.shape[0]
    if auto.active() is None and resolve_cap and B:
        wb = wide_budget or max(B // 8, 8)
        al = _align_adaptive_jit(
            fm, jnp.asarray(reads_f), jnp.asarray(reads_r),
            jnp.asarray(lengths), jnp.asarray(offsets),
            max_mismatches=max_mismatches, narrow_hits=narrow_hits,
            wide_hits=wide_hits, max_alignments=max_alignments,
            kmer_fast=kmer_fast, resolve_cap=resolve_cap,
            uniform_len=uniform_len, wide_budget=wb)
        if defer:
            return al
    else:
        al = align_reads(fm, reads_f, reads_r, lengths, offsets,
                         max_mismatches=max_mismatches,
                         hits_per_seed=narrow_hits,
                         max_alignments=max_alignments, kmer_fast=kmer_fast,
                         resolve_cap=resolve_cap, uniform_len=uniform_len)
    trunc = np.asarray(al.truncated)
    if not trunc.any():
        return al
    idx = np.nonzero(trunc)[0]
    bt = 1 << max(3, int(len(idx) - 1).bit_length())
    pad = np.resize(idx, bt)
    wide = align_reads(fm, np.asarray(reads_f)[pad],
                       np.asarray(reads_r)[pad],
                       np.asarray(lengths)[pad], offsets,
                       max_mismatches=max_mismatches,
                       hits_per_seed=wide_hits,
                       max_alignments=max_alignments, kmer_fast=kmer_fast,
                       uniform_len=uniform_len)
    k = len(idx)
    w_wide = np.asarray(wide.pos).shape[1]
    out = {}
    for f, fill in (("pos", 0), ("strand", 0), ("mm", 0), ("valid", False)):
        a = np.asarray(getattr(al, f))
        if a.shape[1] < w_wide:  # narrow tier compacted to fewer slots
            pad_w = np.full((a.shape[0], w_wide - a.shape[1]), fill,
                            a.dtype)
            a = np.concatenate([a, pad_w], axis=1)
        else:
            a = a.copy()
        a[idx] = np.asarray(getattr(wide, f))[:k, :a.shape[1]]
        out[f] = a
    for f in ("n_hits", "truncated"):
        a = np.asarray(getattr(al, f)).copy()
        a[idx] = np.asarray(getattr(wide, f))[:k]
        out[f] = a
    return Alignments(**out)


@partial(jax.jit, static_argnames=("cap",))
def pack_alignments(al: Alignments, cap: int):
    """Device-side compaction of the (B, M) alignment tables to a flat
    (cap,) list of valid entries (read, pos, strand, mm) in table order —
    the host boundary then transfers ~n_aligned records instead of the
    full (B, M) tables. Returns
    (read, pos, strand, mm, count, overflow)."""
    B, M = al.pos.shape
    flat_valid = al.valid.reshape(-1)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                            (B, M)).reshape(-1)
    csum = jnp.cumsum(flat_valid.astype(jnp.int32))
    n = csum[-1]
    src = jnp.minimum(jnp.searchsorted(
        csum, jnp.arange(1, cap + 1, dtype=jnp.int32)), B * M - 1)
    kept = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(n, cap)
    take = lambda a: jnp.where(kept, a.reshape(-1)[src], 0)
    return (jnp.where(kept, rows[src], -1), take(al.pos),
            take(al.strand.astype(jnp.int32)),
            take(al.mm.astype(jnp.int32)), n, n > cap)


def transfer_alignments(al: Alignments, cap: int | None = None
                        ) -> Alignments:
    """Bring a device Alignments to host numpy via flat packing, falling
    back to direct table transfer when the flat budget overflows. The
    rebuilt tables hold the same valid entries at the same leading slots
    (invalid tails zeroed), so consumers are unchanged."""
    B, M = al.pos.shape
    if cap is None:
        cap = max(4 * B, 64)
    read, pos, strand, mm, n, ovf = pack_alignments(al, cap)
    n_hits = np.asarray(al.n_hits)
    truncated = np.asarray(al.truncated)
    if bool(ovf):   # rare: heavy-multihit batch — take the full tables
        return Alignments(pos=np.asarray(al.pos),
                          strand=np.asarray(al.strand),
                          mm=np.asarray(al.mm),
                          valid=np.asarray(al.valid),
                          n_hits=n_hits, truncated=truncated)
    k = int(n)
    read = np.asarray(read)[:k]
    pos_f = np.asarray(pos)[:k]
    strand_f = np.asarray(strand)[:k]
    mm_f = np.asarray(mm)[:k]
    pos_t = np.zeros((B, M), np.int32)
    strand_t = np.zeros((B, M), np.int8)
    mm_t = np.zeros((B, M), np.int8)
    valid_t = np.zeros((B, M), bool)
    if k:
        first = np.searchsorted(read, read, side="left")
        slot = np.arange(k) - first
        pos_t[read, slot] = pos_f
        strand_t[read, slot] = strand_f
        mm_t[read, slot] = mm_f
        valid_t[read, slot] = True
    return Alignments(pos=pos_t, strand=strand_t, mm=mm_t, valid=valid_t,
                      n_hits=n_hits, truncated=truncated)


def pad_reads(seqs, max_len: int | None = None):
    """Host helper: list of int8 code arrays -> (reads_f, reads_r, lengths)
    left-aligned, -1-padded numpy arrays ready for align_reads."""
    from tophat_tpu.index.fasta import revcomp

    B = len(seqs)
    L = max_len or max((len(s) for s in seqs), default=1)
    reads_f = np.full((B, L), -1, np.int8)
    reads_r = np.full((B, L), -1, np.int8)
    lengths = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        l = min(len(s), L)
        reads_f[i, :l] = s[:l]
        reads_r[i, :l] = revcomp(np.asarray(s[:l], np.int8))
        lengths[i] = l
    return reads_f, reads_r, lengths
