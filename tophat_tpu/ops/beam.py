"""Half-split + k-mer-variant full-sensitivity short-segment alignment.

The pigeonhole scheme in ops/align.py is right for full reads (>= 48 bp:
pieces are long enough that k-mer-shortened seeds have O(1)-wide SA
intervals) but catastrophically wrong for 25 bp segments at gigabase
scale: with 3 pieces of ~8 bp, each piece's SA interval is ~16k wide on a
1 Gbp text and truncating to hits_per_seed keeps ~0.6% of true placements
(measured; scripts/beam_probe.py).

This module covers the same placements as the engine the reference shells
out to (bowtie1 -v 2 per segment, reference src/tophat.py:2339-2344) —
including the split-pair (one mismatch in each half) case bowtie reaches
through its double index — with a search plan that is all fixed-depth
scans, table lookups and flat gathers (fixed shapes that jit):

  1. Half seeds: split the segment at its midpoint into prefix P and
     suffix S; an alignment with mm(S) = 0 is an exact occurrence of S,
     one with mm(P) = 0 an occurrence of P. Both halves are >= 12 chars,
     so their SA intervals hold only ~n/4^12 occurrences: two exact
     backward searches cover every placement whose mismatches fall in
     one half.
  2. Variant seeds (the split-pair case, mm(P) = mm(S) = 1): any such
     placement matches some k-length window of the segment exactly
     except at enumerated positions. Windows are chosen so one of them
     always isolates the suffix mismatch from the prefix one (a window
     [l-k, l) plus [0, k) plus, when the two windows cannot separate a
     mismatch pair adjacent to the midpoint, double-variants of the
     midband); each variant's SA interval comes from ONE k-mer-table
     lookup via key arithmetic — no rank scans at all. This replaces the
     role of bowtie's mirror index (.rev.ebwt) at a cost of a couple
     hundred table gathers per segment instead of a second index in
     memory; the families partition the mismatch-pair space, so no
     placement is searched twice.
  3. Every family's occurrences lay out as back-to-back runs in a
     per-row candidate grid (scatter-added run deltas + row cumsums — no
     giant flat compaction), resolve through the (one, forward) SA, and verify
     as the FULL segment against the word-packed genome + N mask — so
     every reported mm is the true mismatch count (N counts as a
     mismatch even inside a seed window, where the FM text's N->A
     substitution hid it) and residual family overlap is harmless: hits
     are sorted per row and exact (row, pos) duplicates are dropped.

Sensitivity contract: for max_mismatches <= 2 (the reference's segment
default) every placement is found for rows with length >= kmer_k + 2;
shorter rows keep same-half-only sensitivity (at gigabase scale a
<16 bp 2-mismatch query has thousands of placements and the reference's
own engine truncates via -k/--maxbts there). For max_mismatches = 3 the
same-half families are complete but mixed 2|1 splits are only partially
covered — bowtie's own phase-3 backtrack cap (--maxbts 125) prunes the
equivalent search.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tophat_tpu.ops.search import backward_search, resolve_sa
from tophat_tpu.ops.verify import (count_mismatches_packed, pack_reads,
                                   same_contig)

MIN_BEAM_LEN = 10   # shortest row the half-split handles sensibly


def _compact(valid, K, vals):
    """Keep the first K valid lanes in lane order via cumsum + scatter
    (no searchsorted). vals: list of (array, fill). Returns
    (compacted_list, kept_mask (K,), dropped_mask aligned with valid)."""
    csum = jnp.cumsum(valid.astype(jnp.int32))
    keep = valid & (csum <= K)
    slot = jnp.where(keep, csum - 1, K)
    outs = [jnp.full(K + 1, fill, v.dtype).at[slot].set(
        jnp.where(keep, v, fill))[:K] for v, fill in vals]
    kept = jnp.arange(K, dtype=jnp.int32) < jnp.minimum(csum[-1], K)
    return outs, kept, valid & ~keep


def _pack_rows(seg, pos, mm, B: int, max_hits: int):
    """Flat verified hits -> (B, max_hits) tables sorted by pos with
    exact (row, pos) duplicates dropped. seg == B marks dead lanes."""
    R = seg.shape[0]
    s_seg, s_pos, s_mm = jax.lax.sort((seg, pos, mm), num_keys=2)
    prev_seg = jnp.concatenate([jnp.full(1, -1, s_seg.dtype), s_seg[:-1]])
    prev_pos = jnp.concatenate([jnp.full(1, -1, s_pos.dtype), s_pos[:-1]])
    dup = (s_seg == prev_seg) & (s_pos == prev_pos)
    keep = (s_seg < B) & ~dup
    P = jnp.concatenate([jnp.zeros(1, jnp.int32),
                         jnp.cumsum(keep.astype(jnp.int32))])
    first = jnp.searchsorted(s_seg, s_seg, side="left").astype(jnp.int32)
    idx = jnp.arange(R, dtype=jnp.int32)
    slot = P[idx] - P[first]          # kept lanes before i in i's row
    ok = keep & (slot < max_hits)
    row_i = jnp.where(ok, s_seg, B)
    col_i = jnp.clip(slot, 0, max_hits - 1)
    pos_t = jnp.zeros((B, max_hits), jnp.int32).at[
        (row_i, col_i)].set(s_pos, mode="drop")
    mm_t = jnp.zeros((B, max_hits), jnp.int32).at[
        (row_i, col_i)].set(s_mm, mode="drop")
    val_t = jnp.zeros((B, max_hits), bool).at[
        (row_i, col_i)].set(True, mode="drop")
    n_hits = jnp.zeros(B, jnp.int32).at[jnp.clip(s_seg, 0, B - 1)].add(
        keep.astype(jnp.int32), mode="drop")
    return pos_t, mm_t.astype(jnp.int8), val_t, n_hits


def _variant_intervals(fm, rows, lengths, h, seg_ok, *, K: int, nsw: int,
                       h_max: int, pa_cap: int, pb_cap: int):
    """SA intervals of every enumerated window variant, via k-mer-table
    key arithmetic. Returns (lo, hi, pos_off, band_short) with lo/hi/
    pos_off of shape (B, NV); pos_off is the window start (candidate
    segment position = occurrence - pos_off); band_short flags rows
    whose midband exceeds the static double-variant caps."""
    B, L = rows.shape
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None, None]
    # window slots: 0 = W [0, K); 1..nsw-1 = suffix [h + t*K, +K);
    # nsw = tail [l-K, l)
    t = jnp.arange(max(nsw - 1, 0), dtype=jnp.int32)
    starts = jnp.concatenate([
        jnp.zeros((B, 1), jnp.int32),
        h[:, None] + t[None, :] * K,
        (lengths - K)[:, None]], axis=1)                    # (B, NS)
    NS = nsw + 1
    act = jnp.concatenate([
        ((lengths - K) < h)[:, None],                       # W needed only
        (h[:, None] + (t[None, :] + 1) * K) <= lengths[:, None],
        jnp.ones((B, 1), bool)], axis=1)
    act &= ((lengths >= K + 2) & (seg_ok >= 0))[:, None]
    src = starts[:, :, None] + jnp.arange(K, dtype=jnp.int32)[None, None, :]
    wchars = rows[bidx, jnp.clip(src, 0, L - 1)].astype(jnp.int32)
    wok = act & jnp.all((wchars >= 0) & (wchars <= 3), axis=2) \
        & (starts >= 0)
    pw = (4 ** (K - 1 - np.arange(K, dtype=np.int64))).astype(np.int32)
    pw = jnp.asarray(pw)
    key = jnp.sum(jnp.clip(wchars, 0, 3) * pw[None, None, :], axis=2)

    keys_v, off_v, ok_v = [], [], []

    def add(k, o, v):
        keys_v.append(k.reshape(B, -1))
        off_v.append(o.reshape(B, -1))
        ok_v.append(v.reshape(B, -1))

    a3 = jnp.arange(3, dtype=jnp.int32)
    # W singles: prefix positions p < h
    if h_max:
        p = jnp.arange(h_max, dtype=jnp.int32)
        cw = wchars[:, 0, :]                                # (B, K)
        c0 = cw[:, jnp.minimum(p, K - 1)]                   # (B, h_max)
        cvar = (c0[:, :, None] + 1 + a3[None, None, :]) % 4
        delta = (cvar - c0[:, :, None]) * pw[jnp.minimum(p, K - 1)][
            None, :, None]
        vv = (wok[:, 0:1] & (p[None, :] < jnp.minimum(h, K)[:, None])
              )[:, :, None] & jnp.ones((1, 1, 3), bool)
        add(key[:, 0:1, None] + delta, jnp.broadcast_to(
            starts[:, 0:1, None], delta.shape), vv)
    # suffix-window singles: any window position that is a suffix position.
    # Family exclusivity: when the W window is active (it handles every
    # split-pair with j >= K), the tail window keeps only j < K — the
    # families partition the (i, j) space instead of overlapping, which
    # cuts the candidate volume ~30% at the default segment length.
    p = jnp.arange(K, dtype=jnp.int32)
    w_act = (lengths - K) < h                                # W active
    for s in range(1, NS):
        cs = wchars[:, s, :]
        cvar = (cs[:, :, None] + 1 + a3[None, None, :]) % 4
        delta = (cvar - cs[:, :, None]) * pw[None, :, None]
        jpos = starts[:, s:s + 1] + p[None, :]
        in_suffix = jpos >= h[:, None]
        excl = ~w_act[:, None] | (jpos < K)
        vv = (wok[:, s:s + 1] & in_suffix & excl)[:, :, None] \
            & jnp.ones((1, 1, 3), bool)
        add(key[:, s:s + 1, None] + delta, jnp.broadcast_to(
            starts[:, s:s + 1, None], delta.shape), vv)
    # midband doubles on the tail window: i = (l-K)+pa in the prefix,
    # j = h+pb in the suffix with j < K (the pair neither [0,K) nor
    # [l-K, l) can isolate)
    band_short = jnp.zeros(B, bool)
    if pa_cap and pb_cap:
        tail = NS - 1
        pa = jnp.arange(pa_cap, dtype=jnp.int32)
        pb = jnp.arange(pb_cap, dtype=jnp.int32)
        pj = (h - (lengths - K))[:, None] + pb[None, :]     # tail coords
        cA = wchars[:, tail, :][:, jnp.minimum(pa, K - 1)]  # (B, pa)
        cB = jnp.take_along_axis(wchars[:, tail, :],
                                 jnp.clip(pj, 0, K - 1), axis=1)
        band_on = (lengths - K) < h
        okA = band_on[:, None] & (((lengths - K)[:, None] + pa[None, :])
                                  < h[:, None])
        okB = band_on[:, None] & ((h[:, None] + pb[None, :]) < K) \
            & (pj >= 0) & (pj < K)
        dA = (((cA[:, :, None] + 1 + a3[None, None, :]) % 4
               - cA[:, :, None])
              * pw[jnp.minimum(pa, K - 1)][None, :, None])  # (B,pa,3)
        dB = (((cB[:, :, None] + 1 + a3[None, None, :]) % 4
               - cB[:, :, None])
              * jnp.take(pw, jnp.clip(pj, 0, K - 1))[:, :, None])
        kd = (key[:, tail, None, None, None, None]
              + dA[:, :, None, :, None] + dB[:, None, :, None, :])
        vd = (wok[:, tail, None, None, None, None]
              & okA[:, :, None, None, None] & okB[:, None, :, None, None]
              & jnp.ones((1, 1, 1, 3, 3), bool))
        od = jnp.broadcast_to(
            (lengths - K)[:, None, None, None, None], kd.shape)
        add(kd, od, vd)
        band_short = band_on & (
            ((h - (lengths - K)) > pa_cap) | ((K - h) > pb_cap))

    keyv = jnp.concatenate(keys_v, axis=1)
    offv = jnp.concatenate(off_v, axis=1)
    okv = jnp.concatenate(ok_v, axis=1)
    tbl_n = fm.kmer_lo.shape[0]
    kc = jnp.clip(keyv, 0, tbl_n - 1)
    lo = jnp.where(okv, jnp.asarray(fm.kmer_lo)[kc], 0)
    hi = jnp.where(okv, jnp.asarray(fm.kmer_hi)[kc], 0)
    return lo, hi, offv, band_short


def _beam_core(fm, rows, lengths, offsets, *, n_steps: int, max_mm: int,
               max_hits: int, cap_s: int, cap_p: int, cap_v: int,
               spc: int, split_pair: bool, nsw: int, h_max: int,
               pa_cap: int, pb_cap: int, owned_width: int = 0,
               flat_out: bool = False):
    """The whole search as one device program; see module docstring.

    owned_width > 0 (genome-sharded use): candidates starting at or past
    it are dropped before packing. flat_out returns the pre-pack flat
    (seg, pos, mm) lanes (K2,) plus (n/a, trunc) so the sharded caller
    can merge shards before the final per-row sort."""
    B, L = rows.shape
    h = lengths // 2
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]
    col = jnp.arange(n_steps, dtype=jnp.int32)[None, :]

    # exact half seeds, right-aligned for backward_search
    sidx = lengths[:, None] - n_steps + col
    sq = jnp.where(sidx >= h[:, None],
                   rows[bidx, jnp.clip(sidx, 0, L - 1)], -1)
    pidx = h[:, None] - n_steps + col
    pq = jnp.where(pidx >= 0, rows[bidx, jnp.clip(pidx, 0, L - 1)], -1)
    lo2, hi2 = backward_search(
        fm, jnp.concatenate([sq, pq]).astype(jnp.int32))

    ok_len = lengths >= MIN_BEAM_LEN
    seg_ok = jnp.where(ok_len, jnp.arange(B, dtype=jnp.int32), -1)
    trunc = jnp.zeros(B, bool)

    # candidate-run tables, one column per seed family "variant":
    # column 0 = suffix-exact half, 1 = prefix-exact half, 2.. = window
    # variants. Each row's candidate runs pack back-to-back into a
    # (B, spc) grid — run-constant quantities reach lanes through
    # scatter-added deltas + row cumsums (piecewise-linear
    # reconstruction), and the per-read verify operands broadcast along
    # the row, so the per-lane gather count (the currency of this
    # engine) stays at ~3 instead of the ~11 a flat global compaction
    # costs.
    lo_list = [lo2[:B, None], lo2[B:, None]]
    hi_list = [hi2[:B, None], hi2[B:, None]]
    off_list = [h[:, None], jnp.zeros((B, 1), jnp.int32)]
    caps = [cap_s, cap_p]
    if split_pair:
        vlo, vhi, voff, band_short = _variant_intervals(
            fm, rows, lengths, h, seg_ok, K=fm.kmer_k, nsw=nsw,
            h_max=h_max, pa_cap=pa_cap, pb_cap=pb_cap)
        lo_list.append(vlo)
        hi_list.append(vhi)
        off_list.append(voff)
        caps += [cap_v] * vlo.shape[1]
        trunc |= band_short
    lot = jnp.concatenate(lo_list, axis=1)
    hit = jnp.concatenate(hi_list, axis=1)
    offt = jnp.concatenate(off_list, axis=1).astype(jnp.int32)
    NV2 = lot.shape[1]
    w = jnp.where((seg_ok >= 0)[:, None], hit - lot, 0)
    w = jnp.maximum(w, 0)
    capv = jnp.asarray(caps, jnp.int32)[None, :]
    trunc |= (w > capv).any(axis=1)
    w = jnp.minimum(w, capv)
    cumw = jnp.cumsum(w, axis=1)
    total = cumw[:, -1]
    trunc |= total > spc
    starts = cumw - w

    # run-constant quantities reach lanes WITHOUT per-lane gathers: a run
    # v's lanes need sa_row = (lot[v] - starts[v]) + j and pos_off[v] —
    # both piecewise-constant-slope along the row, so scatter-ADD each
    # run's delta at its start column and row-cumsum (zero-width runs at
    # equal starts chain their deltas additively, which is exactly right)
    rowi = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                            (B, NV2))
    scol = jnp.clip(starts, 0, spc - 1)
    base = lot - starts
    d_base = base - jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), base[:, :-1]], axis=1)
    d_off = offt - jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), offt[:, :-1]], axis=1)
    base_p = jnp.zeros((B, spc), jnp.int32).at[(rowi, scol)].add(
        d_base, mode="drop")
    off_p = jnp.zeros((B, spc), jnp.int32).at[(rowi, scol)].add(
        d_off, mode="drop")
    j = jnp.arange(spc, dtype=jnp.int32)[None, :]
    sa_row = jnp.cumsum(base_p, axis=1) + j
    pos_off = jnp.cumsum(off_p, axis=1)
    lane_valid = j < total[:, None]
    pos = resolve_sa(fm, jnp.where(lane_valid, sa_row, 0)) - pos_off

    r_packed, bad_e, len_e = pack_reads(rows, lengths)
    dn = ((fm.n + 15) // 16) if getattr(fm, "pg_dual", False) else 0
    mm = count_mismatches_packed(
        fm.packed_genome, fm.n_mask, pos, r_packed, bad_e, len_e, L,
        has_n=getattr(fm, "has_n", True), dual_nwp=dn)
    ok = (lane_valid & (mm <= max_mm) & (pos >= 0)
          & (pos + lengths[:, None] <= fm.n))
    if offsets.shape[0] > 2:    # multi-contig: reject boundary-crossers
        ok &= same_contig(offsets, pos, lengths[:, None])
    if owned_width:
        ok &= pos < owned_width

    K2 = B * max(8, max_hits)
    segf = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                            (B, spc)).reshape(-1)
    (f_seg, f_pos, f_mm), kept2, dropped2 = _compact(
        ok.reshape(-1), K2,
        [(segf, B), (pos.reshape(-1), jnp.int32(2 ** 30)),
         (mm.reshape(-1), 0)])
    trunc |= jnp.zeros(B, jnp.int32).at[segf].max(
        dropped2.astype(jnp.int32), mode="drop") > 0
    if flat_out:
        return f_seg, f_pos, f_mm, trunc

    pos_t, mm_t, val_t, n_hits = _pack_rows(f_seg, f_pos, f_mm, B,
                                            max_hits)
    trunc |= n_hits > max_hits
    return pos_t, mm_t, val_t, n_hits, trunc


@partial(jax.jit, static_argnames=(
    "n_steps", "max_mm", "max_hits", "cap_s", "cap_p", "cap_v", "spc",
    "split_pair", "nsw", "h_max", "pa_cap", "pb_cap"))
def _beam_jit(fm, rows, lengths, offsets, *, n_steps, max_mm, max_hits,
              cap_s, cap_p, cap_v, spc, split_pair, nsw, h_max, pa_cap,
              pb_cap):
    return _beam_core(fm, rows, lengths, offsets, n_steps=n_steps,
                      max_mm=max_mm, max_hits=max_hits, cap_s=cap_s,
                      cap_p=cap_p, cap_v=cap_v, spc=spc,
                      split_pair=split_pair, nsw=nsw, h_max=h_max,
                      pa_cap=pa_cap, pb_cap=pb_cap)


def beam_plan(fm, L: int, lengths_np, max_mismatches: int):
    """Static search-plan parameters for a batch: grid caps sized from
    expected Poisson interval widths (mean + 6 sigma covers the tail to
    ~1e-9 per seed; genuine repeat families overflow any cap and flag
    `truncated` instead) and the variant-window layout from the batch's
    min/max row lengths."""
    def cap(mu, lo, hi, pad):
        return int(np.clip(mu + 6 * np.sqrt(mu) + pad, lo, hi))

    n_steps = (L + 1) // 2 + 1
    cap_s = cap(fm.n / 4 ** (L - L // 2), 16, 512, 8)
    cap_p = cap(fm.n / 4 ** (L // 2), 16, 512, 8)
    K = getattr(fm, "kmer_k", 0)
    split_pair = bool(
        max_mismatches >= 2 and K >= 6
        and np.asarray(fm.kmer_lo).shape[0] > 0 and L >= K + 2)
    nsw = h_max = pa_cap = pb_cap = 0
    cap_v = 8
    nv = 0
    if split_pair:
        h_max = L // 2
        m_max = L - L // 2
        nsw = max(1, -(-(m_max - K) // K) + 1) if m_max > K else 1
        lens = lengths_np[lengths_np >= K + 2]
        lmin = int(lens.min()) if len(lens) else L
        pa_cap = int(np.clip(K - (lmin + 1) // 2, 0, 4))
        pb_cap = int(np.clip(K - lmin // 2, 0, 4))
        cap_v = cap(fm.n / 4 ** K, 6, 64, 6)
        # effective variant count under family exclusivity: for rows where
        # W is active (l < h + K) the tail contributes only its j < K
        # positions; longer rows run full suffix-window tiling instead
        if L <= 2 * K:
            nv = (3 * h_max + 3 * max(0, K - (L - L // 2))
                  + 9 * pa_cap * pb_cap)
        else:
            nv = 3 * K * nsw
    mu_base = fm.n / 4 ** (L // 2) + fm.n / 4 ** (L - L // 2)
    exp = mu_base + nv * fm.n / 4 ** max(K, 1) if split_pair else mu_base
    spc = int(np.clip(exp + 6 * np.sqrt(max(exp, 1)) + 48, 128, 8192))
    # 128-lane rounding: chosen for an earlier accelerator's tiles; kept
    # until re-measured on the GPU
    spc = -(-spc // 128) * 128
    return dict(n_steps=n_steps, max_mm=max_mismatches, cap_s=cap_s,
                cap_p=cap_p, cap_v=cap_v, spc=spc,
                split_pair=split_pair, nsw=nsw, h_max=h_max,
                pa_cap=pa_cap, pb_cap=pb_cap)


def beam_align_rows(fm, rows, lengths, offsets, *, max_mismatches: int,
                    max_hits: int):
    """Drop-in for ops.align.align_forward_rows on short rows, with full
    bowtie1 -v mismatch sensitivity at any genome size (see module
    docstring for the exact contract). Row-sharded over an active mesh
    (parallel/auto.py); with a range-sharded index the search runs
    per-shard with ownership filtering (parallel/shard_fm.py)."""
    from tophat_tpu.parallel import auto

    rows = np.asarray(rows)
    lengths = np.asarray(lengths, np.int32)
    B, L = rows.shape
    plan = beam_plan(fm, L, lengths, max_mismatches)
    if auto.active() is not None and auto.genome_sharded(fm):
        return auto.sharded_beam_rows(rows, lengths, offsets,
                                      max_hits=max_hits, plan=plan)
    if auto.active() is not None:
        (rd, ln), B0 = auto.shard_rows(rows, lengths)
        out = _beam_jit(auto.replicated(fm), rd, ln,
                        auto.replicated(np.asarray(offsets)),
                        max_hits=max_hits, **plan)
        return tuple(np.asarray(a)[:B0] for a in out)
    return _beam_jit(fm, jnp.asarray(rows), jnp.asarray(lengths),
                     jnp.asarray(offsets), max_hits=max_hits, **plan)
