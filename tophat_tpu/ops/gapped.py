"""Bowtie2-mode gapped initial alignment.

The reference's default aligner is bowtie2 end-to-end `-k` with a driver-
computed score floor: `--score-min C,-(mp_max*edit_dist + 2),0` with
mp = 6,2 / rdg = rfg = 5,3 (reference: src/tophat.py:2328-2339, option
assembly :2246-2353). Reads carrying one small indel align DIRECTLY —
without the segment pipeline. This module reproduces that contract on the device:

For every unaligned read and every pigeonhole seed candidate q, one compare
tensor over diagonal shifts s in [-g, g] yields prefix/suffix mismatch
cumsums for ALL placements with one gap: a deletion of d genome bases with
anchor a = q + s0 costs pref[s0][t] + suf[s0 + d][t]; an insertion of i
read bases costs pref[s0][t] + suf_from[t + i][s0 - i]. Scoring follows
bowtie2: 6*mm + 5 + 3*gap <= 6*read_edit_dist + 2.

The result feeds the pipeline as (a) novel indel EVENTS (reported in the
BED tracks like any discovered indel) and (b) direct read candidates that
bypass the v1.1.4 segment-path admission (this path exists only in
bowtie2-mode, --bowtie2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BIG = jnp.int32(32767)


@partial(jax.jit, static_argnames=("max_gap", "mp_max", "rdg_open",
                                   "rdg_ext", "rfg_open", "rfg_ext"))
def gapped_scan(genome, reads, lengths, cand, cand_valid, floor,
                max_gap: int, mp_max: int = 6, rdg_open: int = 5,
                rdg_ext: int = 3, rfg_open: int = 5, rfg_ext: int = 3):
    """Best single-gap alignment per read over its candidate anchors.

    reads (B, L) genome-space codes; cand (B, C) candidate window starts
    (from the ungapped pigeonhole seeds); floor (B,) per-read penalty
    budget (-score_min). Returns per read:
      (pos, t, gap, mm, ok) — gap > 0 deletion of gap genome bases after
    read prefix t; gap < 0 insertion of -gap read bases at t; penalty
    mp_max*mm + rdg(d) or rfg(i) <= floor, leftmost-best. The penalty
    model is bowtie2's at max quality (--mp/--rdg/--rfg,
    reference src/tophat.py:2328-2339).
    """
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    B, L = reads.shape
    C = cand.shape[1]
    g = max_gap
    S = 2 * g + 1                              # diagonal shifts -g..g
    u = jnp.arange(L, dtype=jnp.int32)

    # compare tensor: bad[b, c, s, u] = read[b,u] vs genome[cand+s-g+u]
    shifts = jnp.arange(-g, g + 1, dtype=jnp.int32)
    gidx = (cand[:, :, None, None] + shifts[None, None, :, None]
            + u[None, None, None, :])
    gv = jnp.where((gidx >= 0) & (gidx < n),
                   genome[jnp.clip(gidx, 0, n - 1)], jnp.int8(5))
    r = reads[:, None, None, :]
    in_read = (u[None, None, None, :] < lengths[:, None, None, None])
    bad = (((gv != r) | (gv >= 4) | (r >= 4) | (r < 0)) & in_read)

    pref = jnp.cumsum(bad, axis=3, dtype=jnp.int32)      # mm in read[0..u]
    # pref_before[t] = mm in read[0:t)
    pref_before = jnp.concatenate(
        [jnp.zeros((B, C, S, 1), jnp.int32), pref[..., :-1]], axis=3)
    suf = jnp.cumsum(bad[..., ::-1], axis=3,
                     dtype=jnp.int32)[..., ::-1]          # mm in read[u:)
    suf = jnp.concatenate([suf, jnp.zeros((B, C, S, 1), jnp.int32)], axis=3)

    t = u[None, None, :]
    best_pen = jnp.full((B, C), BIG)
    best_t = jnp.zeros((B, C), jnp.int32)
    best_gap = jnp.zeros((B, C), jnp.int32)
    best_mm = jnp.zeros((B, C), jnp.int32)
    best_s0 = jnp.zeros((B, C), jnp.int32)

    def consider(pen_t, tt, d, s0, mm_t, state):
        bp, bt, bg, bm, bs = state
        pen = jnp.min(pen_t, axis=2)
        tmin = jnp.argmin(pen_t, axis=2).astype(jnp.int32)
        mmv = jnp.take_along_axis(mm_t, tmin[:, :, None], axis=2)[:, :, 0]
        better = pen < bp
        return (jnp.where(better, pen, bp),
                jnp.where(better, tmin, bt),
                jnp.where(better, d, bg),
                jnp.where(better, mmv, bm),
                jnp.where(better, s0, bs))

    state = (best_pen, best_t, best_gap, best_mm, best_s0)
    interior = (t >= 1) & (t <= lengths[:, None, None] - 1)
    for s0 in range(-g, g + 1):
        # deletions: suffix diagonal s0 + d
        for d in range(1, g + 1):
            if not (-g <= s0 + d <= g):
                continue
            mm_t = (pref_before[:, :, s0 + g, :]
                    + suf[:, :, s0 + d + g, :L])
            pen_t = jnp.where(interior,
                              mp_max * mm_t + rdg_open + rdg_ext * d, BIG)
            state = consider(pen_t, t, d, s0, mm_t, state)
        # insertions: suffix starts at read index t + i, diagonal s0 - i
        for i in range(1, g + 1):
            if not (-g <= s0 - i <= g):
                continue
            suf_at = jnp.clip(t + i, 0, L)
            sfi = jnp.take_along_axis(
                suf[:, :, s0 - i + g, :],
                jnp.broadcast_to(suf_at, (B, C, L)), axis=2)
            mm_t = pref_before[:, :, s0 + g, :] + sfi
            ins_ok = interior & (t + i <= lengths[:, None, None] - 1)
            pen_t = jnp.where(ins_ok,
                              mp_max * mm_t + rfg_open + rfg_ext * i, BIG)
            state = consider(pen_t, t, -i, s0, mm_t, state)
    best_pen, best_t, best_gap, best_mm, best_s0 = state

    ok = cand_valid & (best_pen <= floor[:, None])
    pos = cand + best_s0
    # PER-CANDIDATE results: every passing anchor reports its best
    # placement — the bowtie2 `-k` multi-hit contract (the reference runs
    # bowtie2 in -k K end-to-end mode, src/tophat.py:2286-2353), so
    # repetitive gapped reads keep their multihit set / NH > 1 instead of
    # collapsing to a single best placement (round-3 review task 5)
    return pos, best_t, best_gap, best_mm, jnp.where(ok, best_pen, BIG), ok


MAX_CAND = 8


def b2_score_model(params):
    """Parse the --b2-* tuning surface into (mp_max, rdg, rfg,
    floor_fn(read_len) -> penalty budget). Defaults are the reference
    driver's: mp 6,2 / rdg 5,3 / rfg 5,3 and score-min
    C,-(mp_max*edit+2),0 (src/tophat.py:2328-2339)."""
    def pair(s, d):
        try:
            a, b = str(s).split(",")[:2]
            return int(a), int(b)
        except (ValueError, AttributeError):
            return d

    mp_max, _mp_min = pair(getattr(params, "b2_mp", "6,2"), (6, 2))
    rdg = pair(getattr(params, "b2_rdg", "5,3"), (5, 3))
    rfg = pair(getattr(params, "b2_rfg", "5,3"), (5, 3))
    smin = getattr(params, "b2_score_min", "") or ""
    if smin:
        # bowtie2 function string: C,a[,b] constant / L,a,b linear in
        # read length; the floor is the negated minimum score
        parts = smin.split(",")
        kind = parts[0].strip().upper()
        a = float(parts[1]) if len(parts) > 1 else 0.0
        b = float(parts[2]) if len(parts) > 2 else 0.0
        if kind == "L":
            floor_fn = lambda rl: -(a + b * rl)
        else:                     # C (S/G unsupported -> constant)
            floor_fn = lambda rl: -a
    else:
        edit = params.read_edit_dist
        floor_fn = lambda rl: mp_max * edit + 2
    return mp_max, rdg, rfg, floor_fn


def gapped_from_segments(genome_codes, gs, seg_tables, params,
                         offsets=None):
    """Bowtie2-mode direct gapped alignment of the IUM rows, seeded by the
    ungapped segment hits (the role of bowtie2's own seed-and-extend; the
    score contract is the driver's, reference src/tophat.py:2253-2259).

    Multi-hit: every passing seed anchor contributes its best placement
    (deduped by (pos, t, gap)), up to MAX_CAND per row — the bowtie2 `-k`
    contract, so repetitive gapped reads report NH > 1 and participate in
    -g downsampling like any other multihit set.

    offsets: contig offset table — placements that leave the genome or
    deletions spanning a contig boundary of the concatenated genome are
    dropped (same guard discover_events applies to its own candidates,
    pipeline/juncs.py).

    Returns (events, results): `events` is a pipeline/juncs.py event-table
    dict of the novel indels found; `results` is a list of
    (row, pos, t, gap, mm, ev_key) with ev_key = (kind, left, right) for
    looking the merged event index back up in candidates_for_mate.
    """
    import numpy as np

    from tophat_tpu.ops.events import MAX_INS
    from tophat_tpu.ops.splice import KIND_DELETION, KIND_INSERTION

    seg_pos, seg_mm, seg_valid = (np.asarray(a) for a in seg_tables[:3])
    rows = gs.rows
    if rows == 0:
        return None, []
    S = seg_pos.shape[1]
    # candidate window start implied by each segment hit: hit - cut offset
    anchors = (seg_pos - gs.cuts[:, :S, None]).reshape(rows, -1)
    amm = np.broadcast_to(seg_mm, seg_pos.shape).reshape(rows, -1)
    avalid = seg_valid.reshape(rows, -1) & (gs.read_idx >= 0)[:, None]
    if not avalid.any():
        return None, []

    # unique anchors per row, best segment quality first: sort lanes by
    # (anchor, mm) and keep the first of each anchor run (min mm), then
    # re-rank survivors by (mm, anchor) and take the MAX_CAND best —
    # repetitive reads keep their best-supported anchors instead of the
    # lowest genome coordinates. All composite-int64 sorts, no row loop.
    W = anchors.shape[1]
    a64 = anchors.astype(np.int64) + (1 << 31)
    m64 = np.clip(amm.astype(np.int64), 0, 255)
    key1 = np.where(avalid, (a64 << 16) | m64, np.int64(1) << 62)
    order1 = np.argsort(key1, axis=1, kind="stable")
    a_s = np.take_along_axis(anchors, order1, axis=1)
    m_s = np.take_along_axis(amm, order1, axis=1)
    v_s = np.take_along_axis(avalid, order1, axis=1)
    first = np.ones((rows, W), bool)
    first[:, 1:] = a_s[:, 1:] != a_s[:, :-1]
    v_u = v_s & first
    key2 = np.where(
        v_u, (np.clip(m_s.astype(np.int64), 0, 255) << 33)
        | (a_s.astype(np.int64) + (1 << 31)), np.int64(1) << 62)
    order2 = np.argsort(key2, axis=1, kind="stable")[:, :MAX_CAND]
    cand = np.take_along_axis(a_s, order2, axis=1).astype(np.int32)
    cvalid = np.take_along_axis(v_u, order2, axis=1)
    if not cvalid.any():
        return None, []

    # cap the scan's diagonal window at MAX_INS: an insertion wider than
    # the event-table slot cannot be represented (and would overflow
    # iseq below); deletions keep the same symmetric window
    g = max(1, min(params.read_gap_length,
                   max(params.max_deletion_length,
                       min(params.max_insertion_length, MAX_INS))))
    mp_max, rdg, rfg, floor_fn = b2_score_model(params)
    floor = np.array([floor_fn(int(l)) for l in gs.lengths],
                     np.int32)
    pos, t, gap, mm, pen, ok = (np.asarray(x) for x in gapped_scan(
        genome_codes, jnp.asarray(gs.readsg), jnp.asarray(gs.lengths),
        jnp.asarray(cand), jnp.asarray(cvalid), jnp.asarray(floor),
        max_gap=g, mp_max=mp_max, rdg_open=rdg[0], rdg_ext=rdg[1],
        rfg_open=rfg[0], rfg_ext=rfg[1]))

    glen = int(genome_codes.shape[0])
    off = np.asarray(offsets) if offsets is not None else None
    ev_left, ev_right, ev_kind = [], [], []
    ev_ilen, ev_iseq = [], []
    results = []
    seen = set()
    for r, c in zip(*np.nonzero(ok)):
        r, c = int(r), int(c)
        if int(gs.read_idx[r]) < 0:     # pow2 padding row
            continue
        gp, tt, p0 = int(gap[r, c]), int(t[r, c]), int(pos[r, c])
        if gp == 0:
            continue                    # pure-mismatch placement: the
        #                                 ungapped aligner's domain
        if (r, p0, tt, gp) in seen:     # same placement via another seed
            continue
        seen.add((r, p0, tt, gp))
        rl = int(gs.lengths[r])
        span = rl + gp                  # genome bases consumed
        if p0 < 0 or p0 + span > glen:
            continue                    # out-of-genome placement (the scan
        #                                 counts OOB bases as mismatches,
        #                                 which read_edit_dist can absorb)
        if gp > 0:
            if gp > params.max_deletion_length:
                continue
            left, right = p0 + tt - 1, p0 + tt + gp
            if off is not None and (np.searchsorted(off, left, "right")
                                    != np.searchsorted(off, right, "right")):
                continue                # cross-contig "deletion"
            kind, ilen = KIND_DELETION, 0
            iseq = np.full(MAX_INS, -1, np.int8)
        else:
            if -gp > min(params.max_insertion_length, MAX_INS):
                continue
            left, right = p0 + tt - 1, p0 + tt
            kind, ilen = KIND_INSERTION, -gp
            iseq = np.full(MAX_INS, -1, np.int8)
            iseq[:ilen] = gs.readsg[r, tt:tt + ilen]
        if off is not None and (np.searchsorted(off, p0, "right")
                                != np.searchsorted(off, p0 + span - 1,
                                                   "right")):
            continue                    # placement spans a contig boundary
        ev_left.append(left)
        ev_right.append(right)
        ev_kind.append(kind)
        ev_ilen.append(ilen)
        ev_iseq.append(iseq)
        results.append((int(r), p0, tt, gp, int(mm[r, c]),
                        (int(kind), left, right)))
    if not results:
        return None, []
    events = dict(left=np.array(ev_left, np.int32),
                  right=np.array(ev_right, np.int32),
                  kind=np.array(ev_kind, np.int8),
                  antisense=np.zeros(len(ev_left), bool),
                  ins_len=np.array(ev_ilen, np.int8),
                  ins_seq=np.stack(ev_iseq))
    return events, results
