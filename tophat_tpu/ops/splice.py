"""Splice-junction / indel discovery and event-based realignment.

Device-side re-design of segment_juncs + juncs_db + the spliced side of
long_spanning_reads (reference: src/segment_juncs.cpp, src/juncs_db.cpp,
src/long_spanning_reads.cpp). Three ideas replace the reference's
file-and-subprocess machinery:

1. Everything works in *genome space*: a read is represented by the code
   string that matches the forward genome (the read itself on strand +, its
   reverse complement on strand -), so one forward-coordinate algorithm
   covers both strands (the reference instead mirrors hits and
   reverse-complements support strings case by case,
   segment_juncs.cpp:2905-2920,3596-3607).

2. Junction discovery = the reference's split-segment search
   (look_for_hit_group -> juncs_from_ref_segs, segment_juncs.cpp:3500-3620,
   2052-2360) expressed as fixed-shape window arrays: for each pair of
   segment hits with a gap in [min_segment_intron, max_segment_intron)
   (or skipping one unmapped segment), scan every split point of a 16 bp
   (or seg_len+16 bp) support string for GT..AG / CT..AC motif pairs under a
   2-mismatch budget — all windows and split points evaluated at once.

3. Realignment against candidate events (the juncs_db FASTA -> bowtie ->
   rebase round-trip, juncs_db.cpp:109 + bwt_map.cpp:885) collapses into two
   one-hot cross-correlations on the matrix units: for every (read, event) pair the
   mismatch count of every split point comes from conv(read, left-flank) and
   conv(read, right-flank) lags. No flank FASTA, no second index.

Event kinds unify junctions, deletions and insertions into one table:
  kind 0: junction  (left = last exonic base, right = first exonic base)
  kind 1: deletion  (same coordinates; right - left - 1 bases deleted)
  kind 2: insertion (left = last base before insert; seq = inserted bases)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

LOOK_BP = 8       # anchor bases examined each side of a segment boundary
                  # (reference: look_bp, segment_juncs.cpp:3574)
WINDOW_MM = 2     # split-point mismatch budget (segment_juncs.cpp:2265)

KIND_JUNCTION = 0
KIND_DELETION = 1
KIND_INSERTION = 2
KIND_FUSION = 3   # left on one locus, right on another (contig/strand/far)


# ---------------------------------------------------------------------------
# candidate windows from segment-hit pairs
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PairWindows:
    """Flat table of donor/acceptor scan windows (one per admissible segment
    hit pair). All arrays (W,)."""

    row: Any        # int32 read-row (genome-space strand row) of the window
    gl: Any         # int32 genome pos one past the left anchor hit's end
    gr: Any         # int32 genome pos of the right anchor hit's start
    sup_start: Any  # int32 support span start in the genome-space read
    sup_len: Any    # int32 support span length
    valid: Any      # bool


def _pairs_for_offset(seg_pos, seg_valid, cuts, nseg, doff,
                      min_gap, max_gap):
    """Enumerate (left-hit, partner-hit) combos where the partner is the
    segment `doff` places to the right. Returns flat arrays (R*S*H*H,)."""
    R, S, H = seg_pos.shape
    pl = seg_pos[:, :, :, None]                      # (R, S, H, 1) left hit
    vl = seg_valid[:, :, :, None]
    pr = jnp.roll(seg_pos, -doff, axis=1)[:, :, None, :]    # partner hits
    vr = jnp.roll(seg_valid, -doff, axis=1)[:, :, None, :]
    j = jnp.arange(S, dtype=jnp.int32)[None, :, None, None]
    has_partner_seg = (j + doff) < nseg[:, None, None, None]

    llen = (cuts[:, 1:] - cuts[:, :-1])[:, :, None, None]   # left seg length
    left_end = pl + llen
    dist = pr - left_end
    ok = (vl & vr & has_partner_seg
          & (dist >= min_gap) & (dist < max_gap))

    # a contiguous next-segment partner suppresses all windows for this hit
    # (reference: found_right_seg_partner, segment_juncs.cpp:3531-3536)
    pr1 = jnp.roll(seg_pos, -1, axis=1)[:, :, None, :]
    vr1 = jnp.roll(seg_valid, -1, axis=1)[:, :, None, :]
    has_next = (j + 1) < nseg[:, None, None, None]
    contiguous = jnp.any(vl & vr1 & has_next & (pr1 - left_end == 0),
                         axis=3, keepdims=True)
    ok &= ~contiguous

    rowi = jnp.broadcast_to(
        jnp.arange(R, dtype=jnp.int32)[:, None, None, None], ok.shape)
    # support span: [boundary_after_left - 8, partner_start_boundary + 8)
    # where boundaries are read-space cut offsets (segment_juncs.cpp:3581-3585)
    sup_start = (cuts[:, 1:])[:, :, None, None] - LOOK_BP
    # end_cut[:, j] = cuts[:, min(j + doff, S)] (partner's start boundary)
    end_cut = jnp.concatenate(
        [cuts[:, doff:]] +
        ([jnp.repeat(cuts[:, -1:], doff - 1, axis=1)] if doff > 1 else []),
        axis=1)
    sup_end = end_cut[:, :, None, None] + LOOK_BP

    flat = lambda a: jnp.broadcast_to(a, ok.shape).reshape(-1)
    return PairWindows(
        row=flat(rowi), gl=flat(left_end), gr=flat(pr),
        sup_start=flat(sup_start), sup_len=flat(sup_end - sup_start),
        valid=ok.reshape(-1))


@partial(jax.jit, static_argnames=("min_seg_intron", "max_seg_intron",
                                   "segment_length"))
def build_pair_windows(seg_pos, seg_valid, cuts, nseg, lengths,
                       min_seg_intron: int, max_seg_intron: int,
                       segment_length: int):
    """All candidate windows for a batch.

    seg_pos/seg_valid : (R, S, H) genome-space segment hit tables
                        (row-major over strands; segment index is GENOME
                        order, see pipeline/segment.py)
    cuts              : (R, S+1) genome-space segment boundary offsets
    nseg              : (R,) segments per read
    lengths           : (R,) read lengths

    drs windows pair adjacent segments with gap in [min, max); rrs windows
    skip one (unmapped) segment with gap in [min+seg_len, max+seg_len)
    (reference: segment_juncs.cpp:3538-3570). rrs windows take precedence
    when both exist for a hit (reference :3577).
    """
    drs = _pairs_for_offset(seg_pos, seg_valid, cuts, nseg, 1,
                            min_seg_intron, max_seg_intron)
    rrs = _pairs_for_offset(seg_pos, seg_valid, cuts, nseg, 2,
                            min_seg_intron + segment_length,
                            max_seg_intron + segment_length)
    R, S, H = seg_pos.shape
    # "use rrs if any, else drs" applies per left hit (r, j, h1)
    rrs_any = jnp.any(rrs.valid.reshape(R, S, H, H), axis=3, keepdims=True)
    drs_valid = drs.valid.reshape(R, S, H, H) & ~rrs_any
    drs = dataclasses.replace(drs, valid=drs_valid.reshape(-1))

    cat = lambda a, b: jnp.concatenate([a, b])
    out = PairWindows(
        row=cat(drs.row, rrs.row), gl=cat(drs.gl, rrs.gl),
        gr=cat(drs.gr, rrs.gr),
        sup_start=cat(drs.sup_start, rrs.sup_start),
        sup_len=cat(drs.sup_len, rrs.sup_len),
        valid=cat(drs.valid, rrs.valid))

    # clamp the support span to the read (reference substr semantics)
    rl = lengths[out.row]
    s0 = jnp.clip(out.sup_start, 0, rl)
    s1 = jnp.clip(out.sup_start + out.sup_len, 0, rl)
    return dataclasses.replace(out, sup_start=s0, sup_len=s1 - s0)


# ---------------------------------------------------------------------------
# motif scan over windows -> candidate junctions
# ---------------------------------------------------------------------------

def _window_sharded(scan_jit, genome, readsg, win, sup_max):
    """Run a jitted window scan with the window axis sharded over the active
    mesh (parallel/auto.py) — genome and genome-space reads replicated, the
    flat window table split across devices like the reference's read-range
    thread partition (segment_juncs.cpp:4763)."""
    from tophat_tpu.parallel import auto

    if auto.active() is None or win.row.shape[0] == 0:
        return scan_jit(genome, readsg, win, sup_max)
    win_d, W = auto.shard_pytree_rows(win)
    out = scan_jit(auto.replicated(genome), auto.replicated(readsg),
                   win_d, sup_max)
    # host-gather at the merge point: slicing a mesh-sharded array and
    # feeding it to a replicated jit forces a cross-device reshard that is
    # pathologically slow on the virtual CPU mesh
    return tuple(np.asarray(a)[:W] for a in out)


@partial(jax.jit, static_argnames=("sup_max",))
def _scan_windows_jit(genome, readsg, win: PairWindows, sup_max: int):
    """Scan every split point of every window for donor/acceptor pairs.

    Returns (left, right, antisense, valid), each (W, sup_max):
    junction left/right in the TopHat convention (last exonic base, first
    exonic base). Mirrors juncs_from_ref_segs POINT_DIR_BOTH
    (reference: segment_juncs.cpp:2240-2289): split i is admissible when
    prefix(support[:i]) anchored at the window start plus
    suffix(support[i:]) anchored at the window end have <= 2 mismatches and
    the dinucleotides at both ends of the implied intron are GT..AG
    (forward) or CT..AC (reverse).
    """
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    W = win.row.shape[0]
    t = jnp.arange(sup_max, dtype=jnp.int32)[None, :]

    sup_idx = win.sup_start[:, None] + t
    in_sup = t < win.sup_len[:, None]
    support = readsg[win.row[:, None], jnp.clip(sup_idx, 0, readsg.shape[1] - 1)]
    support = jnp.where(in_sup, support, jnp.int8(-1))

    wl = win.gl[:, None] - LOOK_BP          # window start (prefix anchor)
    wr = win.gr[:, None] + LOOK_BP          # window end (suffix anchor)

    gidx_l = wl + t
    gl_codes = genome[jnp.clip(gidx_l, 0, n - 1)]
    gl_codes = jnp.where((gidx_l >= 0) & (gidx_l < n), gl_codes, jnp.int8(5))
    pref_mm = jnp.cumsum(
        ((gl_codes != support) | (gl_codes >= 4) | (support >= 4)) & in_sup,
        axis=1)                              # pref_mm[:, i] = mm in [0, i]

    gidx_r = wr - win.sup_len[:, None] + t
    gr_codes = genome[jnp.clip(gidx_r, 0, n - 1)]
    gr_codes = jnp.where((gidx_r >= 0) & (gidx_r < n), gr_codes, jnp.int8(5))
    suf_mm_rev = jnp.cumsum(
        (((gr_codes != support) | (gr_codes >= 4) | (support >= 4))
         & in_sup)[:, ::-1], axis=1)[:, ::-1]  # mm in [i, end)

    # split at i: prefix [0, i), suffix [i, end)
    pref_before = jnp.concatenate(
        [jnp.zeros((W, 1), pref_mm.dtype), pref_mm[:, :-1]], axis=1)
    budget_ok = (pref_before + suf_mm_rev) <= WINDOW_MM

    # dinucleotides: donor side at window-start + i, acceptor side at the
    # suffix-anchored position (reference pos = seg_len - (read_len-i) - 2)
    dpos = wl + t
    apos = wr - (win.sup_len[:, None] - t) - 2
    g1 = genome[jnp.clip(dpos, 0, n - 1)]
    g2 = genome[jnp.clip(dpos + 1, 0, n - 1)]
    a1 = genome[jnp.clip(apos, 0, n - 1)]
    a2 = genome[jnp.clip(apos + 1, 0, n - 1)]
    dinuc_ok = (dpos >= 0) & (dpos + 1 < n) & (apos >= 0) & (apos + 1 < n)

    # three donor/acceptor classes, each searched forward and as its
    # reverse complement (= antisense junction) — the reference runs
    # juncs_from_ref_segs once per class: GT-AG, GC-AG, AT-AC
    # (segment_juncs.cpp:3618-3648). Codes A=0 C=1 G=2 T=3.
    fwd = (((g1 == 2) & (g2 == 3) & (a1 == 0) & (a2 == 2))    # GT..AG
           | ((g1 == 2) & (g2 == 1) & (a1 == 0) & (a2 == 2))  # GC..AG
           | ((g1 == 0) & (g2 == 3) & (a1 == 0) & (a2 == 1)))  # AT..AC
    rev = (((g1 == 1) & (g2 == 3) & (a1 == 0) & (a2 == 1))    # CT..AC
           | ((g1 == 1) & (g2 == 3) & (a1 == 2) & (a2 == 1))  # CT..GC
           | ((g1 == 2) & (g2 == 3) & (a1 == 0) & (a2 == 3)))  # GT..AT

    scan_ok = in_sup & (t <= win.sup_len[:, None] - 2)  # i <= read_len - 2
    valid = (win.valid[:, None] & scan_ok & budget_ok & dinuc_ok
             & (fwd | rev) & (apos > dpos))
    left = dpos - 1
    right = apos + 2
    return left, right, rev, valid


def scan_windows(genome, readsg, win: PairWindows, sup_max: int):
    return _window_sharded(_scan_windows_jit, genome, readsg, win, sup_max)


@partial(jax.jit, static_argnames=("cap",))
def compact_scan_hits(left, right, rev, valid, win_row, cap: int):
    """Device-compact the (W, sup_max) scan grids to flat (cap,) hit lists
    (left, right, rev, row, count, overflow) so only kilobytes cross the
    host boundary instead of the full grids."""
    W, T = valid.shape
    rows = jnp.broadcast_to(win_row[:, None], (W, T))
    (l, r, v, rw), cvalid, ovf = compact_by_valid(
        valid.reshape(-1),
        [left.reshape(-1), right.reshape(-1), rev.reshape(-1),
         rows.reshape(-1)], cap)
    return l, r, v, rw, cvalid.sum(), ovf


def _fusion_pairs_for_offset(seg_pos, seg_valid, cuts, nseg, lengths,
                             offsets, fusion_min_dist, doff):
    R, S, H = seg_pos.shape
    offsets = jnp.asarray(offsets).astype(jnp.int32)
    pl = seg_pos[:, :, :, None]
    vl = seg_valid[:, :, :, None]
    pr = jnp.roll(seg_pos, -doff, axis=1)[:, :, None, :]
    vr = jnp.roll(seg_valid, -doff, axis=1)[:, :, None, :]
    j = jnp.arange(S, dtype=jnp.int32)[None, :, None, None]
    has_partner = (j + doff) < nseg[:, None, None, None]

    llen = (cuts[:, 1:] - cuts[:, :-1])[:, :, None, None]
    left_end = pl + llen
    cid_l = jnp.searchsorted(offsets, pl, side="right")
    cid_r = jnp.searchsorted(offsets, pr, side="right")
    dist = pr - left_end
    fusionish = (cid_l != cid_r) | (jnp.abs(dist) >= fusion_min_dist)
    ok = vl & vr & has_partner & fusionish

    rowi = jnp.broadcast_to(
        jnp.arange(R, dtype=jnp.int32)[:, None, None, None], ok.shape)
    sup_start = (cuts[:, 1:])[:, :, None, None] - LOOK_BP
    end_cut = jnp.concatenate(
        [cuts[:, doff:]] +
        ([jnp.repeat(cuts[:, -1:], doff - 1, axis=1)] if doff > 1 else []),
        axis=1)
    sup_end = end_cut[:, :, None, None] + LOOK_BP

    flat = lambda a: jnp.broadcast_to(a, ok.shape).reshape(-1)
    return PairWindows(
        row=flat(rowi), gl=flat(left_end), gr=flat(pr),
        sup_start=flat(sup_start), sup_len=flat(sup_end - sup_start),
        valid=ok.reshape(-1))


@partial(jax.jit, static_argnames=("fusion_min_dist",))
def build_fusion_windows(seg_pos, seg_valid, cuts, nseg, lengths, offsets,
                         fusion_min_dist: int):
    """Candidate fusion windows: same-row segment-hit pairs (adjacent, or
    skipping one unmapped break-spanning segment) whose placements are on
    different contigs or >= fusion_min_dist apart on the same contig
    (reference: detect_fusion gating, segment_juncs.cpp:3288). FF
    orientation only; FR/RF require cross-strand chaining (later round)."""
    drs = _fusion_pairs_for_offset(seg_pos, seg_valid, cuts, nseg, lengths,
                                   offsets, fusion_min_dist, 1)
    rrs = _fusion_pairs_for_offset(seg_pos, seg_valid, cuts, nseg, lengths,
                                   offsets, fusion_min_dist, 2)
    cat = lambda a, b: jnp.concatenate([a, b])
    win = PairWindows(
        row=cat(drs.row, rrs.row), gl=cat(drs.gl, rrs.gl),
        gr=cat(drs.gr, rrs.gr),
        sup_start=cat(drs.sup_start, rrs.sup_start),
        sup_len=cat(drs.sup_len, rrs.sup_len),
        valid=cat(drs.valid, rrs.valid))
    rl = lengths[win.row]
    s0 = jnp.clip(win.sup_start, 0, rl)
    s1 = jnp.clip(win.sup_start + win.sup_len, 0, rl)
    return dataclasses.replace(win, sup_start=s0, sup_len=s1 - s0)


@partial(jax.jit, static_argnames=("sup_max",))
def _scan_fusion_windows_jit(genome, readsg, win: PairWindows, sup_max: int):
    """Best breakpoint per fusion window: the split minimizing support-read
    mismatches (no splice motif requirement — reference detect_fusion scans
    all split points, segment_juncs.cpp:2629). Returns per-window
    (left, right, best_mm, valid)."""
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    W = win.row.shape[0]
    t = jnp.arange(sup_max, dtype=jnp.int32)[None, :]

    sup_idx = win.sup_start[:, None] + t
    in_sup = t < win.sup_len[:, None]
    support = readsg[win.row[:, None], jnp.clip(sup_idx, 0,
                                                readsg.shape[1] - 1)]
    support = jnp.where(in_sup, support, jnp.int8(-1))

    wl = win.gl[:, None] - LOOK_BP
    wr = win.gr[:, None] + LOOK_BP

    def mk(idx):
        g = genome[jnp.clip(idx, 0, n - 1)]
        return jnp.where((idx >= 0) & (idx < n), g, jnp.int8(5))

    gl_codes = mk(wl + t)
    pref_mm = jnp.cumsum(
        ((gl_codes != support) | (gl_codes >= 4) | (support >= 4)) & in_sup,
        axis=1)
    gr_codes = mk(wr - win.sup_len[:, None] + t)
    suf_mm = jnp.cumsum(
        (((gr_codes != support) | (gr_codes >= 4) | (support >= 4))
         & in_sup)[:, ::-1], axis=1)[:, ::-1]
    pref_before = jnp.concatenate(
        [jnp.zeros((W, 1), pref_mm.dtype), pref_mm[:, :-1]], axis=1)

    errs = jnp.where(in_sup & (t >= 1), pref_before + suf_mm, 32767)
    best = jnp.min(errs, axis=1).astype(jnp.int32)
    best_t = jnp.argmin(errs, axis=1).astype(jnp.int32)
    left = wl[:, 0] + best_t - 1
    right = wr[:, 0] - (win.sup_len - best_t)
    valid = win.valid & (best <= WINDOW_MM)
    return left, right, best, valid


def scan_fusion_windows(genome, readsg, win: PairWindows, sup_max: int):
    return _window_sharded(_scan_fusion_windows_jit, genome, readsg, win,
                           sup_max)


# ---------------------------------------------------------------------------
# compaction: keep device memory bounded before the expensive scans
# ---------------------------------------------------------------------------

def compact_by_valid(valid, arrays, cap: int):
    """Stable-partition `arrays` so valid rows come first; keep `cap` rows.
    Returns (compacted_arrays, compacted_valid, overflowed).

    Cumsum + searchsorted-gather instead of argsort: a stable argsort over
    the flat window table (tens of millions of lanes) is a multi-pass
    sort; instead, slot k of the output is element
    searchsorted(cumsum(valid), k+1) — cap*log(n) binary-search work plus
    plain gathers (on the CPU test backend a 33M-lane scatter lowers to a
    serial loop)."""
    valid = valid.reshape(-1)
    if valid.shape[0] == 0:
        out = [jnp.zeros((cap,) + a.shape[1:], a.dtype) for a in arrays]
        return out, jnp.zeros(cap, bool), jnp.asarray(False)
    csum = jnp.cumsum(valid.astype(jnp.int32))
    nvalid = csum[-1]
    src = jnp.searchsorted(csum, jnp.arange(1, cap + 1, dtype=jnp.int32))
    src = jnp.minimum(src, valid.shape[0] - 1)
    cvalid = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(nvalid, cap)
    out = []
    for a in arrays:
        a = a.reshape(valid.shape[0], *a.shape[1:])
        g = a[src]
        zero = jnp.zeros((), a.dtype)
        mask = cvalid.reshape((cap,) + (1,) * (a.ndim - 1))
        out.append(jnp.where(mask, g, zero))
    return out, cvalid, nvalid > cap


@partial(jax.jit, static_argnames=("cap",))
def compact_windows(win: PairWindows, cap: int):
    arrays, valid, overflow = compact_by_valid(
        win.valid, [win.row, win.gl, win.gr, win.sup_start, win.sup_len], cap)
    return PairWindows(row=arrays[0], gl=arrays[1], gr=arrays[2],
                       sup_start=arrays[3], sup_len=arrays[4],
                       valid=valid), overflow


# ---------------------------------------------------------------------------
# indel discovery from adjacent segment-hit pairs
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_deletion", "max_insertion",
                                   "cap"))
def build_indel_pairs(seg_pos, seg_mm, seg_valid, cuts, nseg,
                      max_deletion: int, max_insertion: int, cap: int):
    """Adjacent same-strand segment-hit pairs whose genomic extent differs
    from the 2-segment read span by a small amount (the indel gating of
    reference segment_juncs.cpp:2921-2938). Output compacted to `cap` rows:
    dict of (cap,) arrays row, pl, right_end, span, disc, c0, segs_mm, valid.
    """
    R, S, H = seg_pos.shape

    pl = seg_pos[:, :, :, None]
    vl = seg_valid[:, :, :, None]
    ml = seg_mm[:, :, :, None].astype(jnp.int32)
    pr = jnp.roll(seg_pos, -1, axis=1)[:, :, None, :]
    vr = jnp.roll(seg_valid, -1, axis=1)[:, :, None, :]
    mr = jnp.roll(seg_mm, -1, axis=1)[:, :, None, :].astype(jnp.int32)
    j = jnp.arange(S, dtype=jnp.int32)[None, :, None, None]
    has_partner = (j + 1) < nseg[:, None, None, None]

    c0 = cuts[:, :-1][:, :, None, None]                 # pair span start
    c2 = jnp.roll(cuts, -2, axis=1)[:, :S][:, :, None, None]  # span end
    span = c2 - c0                                       # 2-seg read length
    right_end = pr + (c2 - jnp.roll(cuts, -1, axis=1)[:, :S][:, :, None, None])
    apparent = right_end - pl
    disc = apparent - span                               # length discrepancy

    pair_ok = vl & vr & has_partner
    indel_ok = pair_ok & (
        ((disc > 0) & (disc <= max_deletion))
        | ((disc < 0) & (disc >= -max_insertion)))

    P = R * S * H * H
    flat = lambda a: jnp.broadcast_to(a, (R, S, H, H)).reshape(P)
    rowf = flat(jnp.broadcast_to(
        jnp.arange(R, dtype=jnp.int32)[:, None, None, None], (R, S, H, H)))
    arrays, valid, overflow = compact_by_valid(
        indel_ok.reshape(P),
        [rowf, flat(pl), flat(right_end), flat(span), flat(disc), flat(c0),
         flat(ml + mr)], cap)
    return dict(row=arrays[0], pl=arrays[1], right_end=arrays[2],
                span=arrays[3], disc=arrays[4], c0=arrays[5],
                segs_mm=arrays[6], valid=valid), overflow


@partial(jax.jit, static_argnames=("two_seg_max",))
def _scan_indel_pairs_jit(genome, readsg, lengths, pairs, two_seg_max: int):
    """detect_small_deletion / detect_small_insertion semantics
    (reference: segment_juncs.cpp:2470-2628).

    For a pair with discrepancy d: d>0 -> deletion of d bases, d<0 ->
    insertion of |d| read bases. The event position is the leftmost split
    minimizing mismatches of the 2-segment read portion against the
    left-anchored and right-anchored genome windows; kept only if that
    minimum improves on the segment alignments' own mismatch total
    (strictly, when the two segments cover the whole read).

    Returns per-pair: kind, left, right, ins_len, valid, best_t, row,
    ins_read_off (all (P,)) — insertion sequences are gathered host-side.
    """
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    rowf = pairs["row"]
    plf = pairs["pl"]
    ref_ = pairs["right_end"]
    spanf = pairs["span"]
    discf = pairs["disc"]
    c0f = pairs["c0"]
    segs_mm = pairs["segs_mm"]
    pvalid = pairs["valid"]
    P = rowf.shape[0]
    del_okf = pvalid & (discf > 0)
    ins_okf = pvalid & (discf < 0)

    T = two_seg_max + 1
    t = jnp.arange(T, dtype=jnp.int32)[None, :]

    # the 2-segment read portion, genome space
    ridx = c0f[:, None] + jnp.arange(two_seg_max, dtype=jnp.int32)[None, :]
    in_span = jnp.arange(two_seg_max)[None, :] < spanf[:, None]
    rseq = readsg[rowf[:, None], jnp.clip(ridx, 0, readsg.shape[1] - 1)]
    rseq = jnp.where(in_span, rseq, jnp.int8(-1))

    # deletion scan: read vs genome[pl : pl+span] (prefix) and
    # genome[right_end-span : right_end] (suffix). insertion scan compares the
    # *genomic* stretch genome[pl : right_end] (length span+disc < span) with
    # the read's two ends; equivalently prefix read[0:t] at pl and suffix
    # read[t-disc:] ending at right_end. Both reduce to the same two
    # comparison tables with different suffix offsets.
    def mk(codes_idx):
        g = genome[jnp.clip(codes_idx, 0, n - 1)]
        return jnp.where((codes_idx >= 0) & (codes_idx < n), g, jnp.int8(5))

    gidx_l = plf[:, None] + jnp.arange(two_seg_max, dtype=jnp.int32)[None, :]
    gL = mk(gidx_l)
    pref_mm = jnp.cumsum(((gL != rseq) | (gL >= 4) | (rseq >= 4)) & in_span,
                         axis=1)
    # pref_before[t] = mismatches in read[0:t); width T so t may reach span
    pref_before = jnp.concatenate(
        [jnp.zeros((P, 1), pref_mm.dtype), pref_mm], axis=1)

    gidx_r = ref_[:, None] - spanf[:, None] + jnp.arange(
        two_seg_max, dtype=jnp.int32)[None, :]
    gR = mk(gidx_r)
    suf_mm = jnp.cumsum((((gR != rseq) | (gR >= 4) | (rseq >= 4))
                         & in_span)[:, ::-1], axis=1)[:, ::-1]
    # suf_mm[t] = mismatches in read[t:span); extend so t may reach span
    suf_mm = jnp.concatenate(
        [suf_mm, jnp.zeros((P, 1), suf_mm.dtype)], axis=1)

    # deletion: split t in [0, span]: prefix [0,t) left-anchored + suffix
    # [t, span) right-anchored. For insertion the genomic sequence is the
    # short one: split g in [0, span+disc]: genome prefix [0,g) vs read
    # start, genome suffix [g,..) vs read end -> in read terms prefix [0,g)
    # left-anchored and suffix [g-disc, span) right-anchored; the |disc|
    # inserted read bases [g, g-disc) are counted against nothing here
    # (they are the insertion itself).
    errs_del = pref_before[:, :T] + jnp.where(
        t <= spanf[:, None], suf_mm[:, :T], 32767)
    suf_at = jnp.clip(t - discf[:, None], 0, two_seg_max)
    errs_ins = pref_before[:, :T] + jnp.where(
        (t - discf[:, None]) <= spanf[:, None],
        jnp.take_along_axis(suf_mm, suf_at, axis=1), 32767)
    glen = spanf + discf  # genomic length for insertions
    errs_ins = jnp.where(t <= glen[:, None], errs_ins, 32767)
    errs_del = jnp.where(t <= spanf[:, None], errs_del, 32767)

    errs = jnp.where(del_okf[:, None], errs_del,
                     jnp.where(ins_okf[:, None], errs_ins, 32767))
    best_err = jnp.min(errs, axis=1).astype(jnp.int32)
    best_t = jnp.argmin(errs, axis=1).astype(jnp.int32)  # leftmost minimum

    # improvement gating (reference: segment_juncs.cpp:2527-2538, 2608-2619)
    covers_whole = spanf >= lengths[rowf]
    adjustment = jnp.where(covers_whole, -1, 0)
    improved = best_err <= (segs_mm + adjustment)
    # insertion extra guard: bestInsertPosition + |disc| <= genomic length
    # (reference: segment_juncs.cpp:2535)
    ins_guard = (best_t - discf) <= (spanf + discf)

    kind = jnp.where(del_okf, KIND_DELETION, KIND_INSERTION).astype(jnp.int8)
    left = plf + best_t - 1
    right = jnp.where(del_okf, plf + best_t + discf, left + 1)
    ins_len = jnp.where(ins_okf, -discf, 0).astype(jnp.int8)
    valid = (del_okf | (ins_okf & ins_guard)) & improved
    # inserted read bases start at read offset c0 + best_t in genome space
    ins_read_off = c0f + best_t
    return kind, left, right, ins_len, valid, best_t, rowf, ins_read_off


def scan_indel_pairs(genome, readsg, lengths, pairs, two_seg_max: int):
    """_scan_indel_pairs_jit with the pair axis sharded over the active
    mesh (parallel/auto.py); genome, reads and lengths replicated."""
    from tophat_tpu.parallel import auto

    if auto.active() is None or pairs["row"].shape[0] == 0:
        return _scan_indel_pairs_jit(genome, readsg, lengths, pairs,
                                     two_seg_max)
    pairs_d, P_orig = auto.shard_pytree_rows(pairs)
    out = _scan_indel_pairs_jit(
        auto.replicated(genome), auto.replicated(readsg),
        auto.replicated(lengths), pairs_d, two_seg_max)
    return tuple(a[:P_orig] for a in out)
