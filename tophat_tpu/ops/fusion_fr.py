"""Cross-strand fusion search (FR / RF directions).

An FR read is piece A on strand + followed by piece B on strand -: its
forward codes have a genomic PREFIX match and its reverse-complement codes
have a genomic PREFIX match, the two prefixes together covering the read
(reference: detect_fusion reverse-complements one side,
segment_juncs.cpp:2629; fusion dirs in fusions.h:24). An RF read is the
suffix+suffix mirror.

In the genome-space row layout (pipeline/segment.py) read r owns rows r
(forward) and r+R (reverse complement). Every segment hit implies an
"unspliced anchor" — the genome position read base 0 would occupy if the
whole row were contiguous (hit_pos - segment_cut). Candidate (A, B) anchor
pairs are scanned over all split points t with two per-row cumulative
mismatch tables:
  FR: prefix_mm_fwd(t) + prefix_mm_rc(L - t)
  RF: suffix_mm_fwd(t) + suffix_mm_rc(L - t)
keeping splits within a 2-mismatch budget. Mis-anchored pairs self-reject
because a wrong anchor cannot fit the budget.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

FR_MM = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FrPairs:
    read: Any      # (P,) original read index
    anchor_a: Any  # (P,) fwd-row implied unspliced anchor (read base 0)
    anchor_b: Any  # (P,) rev-row implied unspliced anchor
    valid: Any


@partial(jax.jit, static_argnames=("cap",))
def build_fr_pairs(seg_pos, seg_valid, cuts, lengths, cap: int):
    """All (fwd-row hit, rev-row hit) anchor combos per read, compacted."""
    rows, S, H = seg_pos.shape
    R = rows // 2
    anchors = seg_pos - cuts[:, :-1][:, :, None]     # (rows, S, H)
    aA = anchors[:R].reshape(R, S * H)[:, :, None]
    vA = seg_valid[:R].reshape(R, S * H)[:, :, None]
    aB = anchors[R:].reshape(R, S * H)[:, None, :]
    vB = seg_valid[R:].reshape(R, S * H)[:, None, :]
    ok = vA & vB
    shape = ok.shape
    flat = lambda a: jnp.broadcast_to(a, shape).reshape(-1)
    pairs = FrPairs(
        read=flat(jnp.arange(R, dtype=jnp.int32)[:, None, None]),
        anchor_a=flat(aA), anchor_b=flat(aB), valid=ok.reshape(-1))
    order = jnp.argsort(~pairs.valid, stable=True)[:cap]
    take = lambda a: jnp.take(a, order)
    return FrPairs(read=take(pairs.read), anchor_a=take(pairs.anchor_a),
                   anchor_b=take(pairs.anchor_b), valid=take(pairs.valid))


@partial(jax.jit, static_argnames=("L", "pattern"))
def scan_fr_pairs(genome, reads_f, reads_r, lengths, pairs: FrPairs,
                  L: int, pattern: str):
    """Best split per anchor pair.

    pattern "prefix" (FR): fwd prefix [0:t) at anchor_a, rc prefix
    [0:rl-t) at anchor_b. Returns (t, leftA, leftB, mm, valid) where
    leftA/leftB are each piece's LAST aligned genome base.
    pattern "suffix" (RF): fwd suffix [t:) and rc suffix [rl-t:).
    Returns (t, rightA, rightB, mm, valid) with each piece's FIRST base.
    """
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    P = pairs.read.shape[0]
    rl = lengths[pairs.read]
    u = jnp.arange(L, dtype=jnp.int32)[None, :]

    def mk(idx):
        g = genome[jnp.clip(idx, 0, n - 1)]
        return jnp.where((idx >= 0) & (idx < n), g, jnp.int8(5))

    ga = mk(pairs.anchor_a[:, None] + u)
    ra = reads_f[pairs.read[:, None], jnp.clip(u, 0, L - 1)]
    bad_a = (ga != ra) | (ga >= 4) | (ra >= 4) | (ra < 0)
    gb = mk(pairs.anchor_b[:, None] + u)
    rb = reads_r[pairs.read[:, None], jnp.clip(u, 0, L - 1)]
    bad_b = (gb != rb) | (gb >= 4) | (rb >= 4) | (rb < 0)
    in_read = u < rl[:, None]

    t = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    ut = jnp.clip(rl[:, None] - t, 0, L)
    if pattern == "prefix":
        pa = jnp.cumsum(bad_a & in_read, axis=1)
        mmA = jnp.concatenate([jnp.zeros((P, 1), pa.dtype), pa], axis=1)
        pb = jnp.cumsum(bad_b & in_read, axis=1)
        mmB = jnp.concatenate([jnp.zeros((P, 1), pb.dtype), pb], axis=1)
        tot = (jnp.take_along_axis(mmA, jnp.clip(t, 0, L), axis=1)
               + jnp.take_along_axis(mmB, ut, axis=1))
    else:
        sa = jnp.cumsum((bad_a & in_read)[:, ::-1], axis=1)[:, ::-1]
        mmA = jnp.concatenate([sa, jnp.zeros((P, 1), sa.dtype)], axis=1)
        sb = jnp.cumsum((bad_b & in_read)[:, ::-1], axis=1)[:, ::-1]
        mmB = jnp.concatenate([sb, jnp.zeros((P, 1), sb.dtype)], axis=1)
        tot = (jnp.take_along_axis(mmA, jnp.clip(t, 0, L), axis=1)
               + jnp.take_along_axis(mmB, ut, axis=1))

    interior = (t >= 1) & (t <= rl[:, None] - 1)
    tot = jnp.where(interior, tot, 32767)
    best_t = jnp.argmin(tot, axis=1).astype(jnp.int32)
    best = jnp.min(tot, axis=1).astype(jnp.int32)
    valid = pairs.valid & (best <= FR_MM)
    if pattern == "prefix":
        posA = pairs.anchor_a + best_t - 1              # last base, piece A
        posB = pairs.anchor_b + (rl - best_t) - 1       # last base, piece B
    else:
        posA = pairs.anchor_a + best_t                  # first base, piece A
        posB = pairs.anchor_b + (rl - best_t)           # first base, piece B
    return best_t, posA, posB, best, valid


def _one_hot(codes, dtype=jnp.float32):
    # The convolutions below multiply these 0/1 float32 one-hots at default
    # precision. Where that means TF32 (on the GPU), 0 and 1 are still exact
    # and products accumulate in float32, so the match counts (integers
    # <= L) are exact.
    return (codes[..., None] == jnp.arange(4, dtype=codes.dtype)).astype(dtype)


@partial(jax.jit, static_argnames=("pattern",))
def realign_fr_events(genome, rows_f, rows_r, lengths, pA, pB,
                      ev_valid, pattern: str):
    """Realign every read against known cross-strand fusion breakpoints —
    the role of bowtie mapping segments against juncs_db's fr/rev fusion
    flank records (juncs_db.cpp:152 print_fusion): reads whose short piece
    has no mappable segment still align across an already-discovered break.

    pattern "fr": pA/pB are each piece's LAST genome base (piece A = fwd
    prefix of the read, piece B = fwd prefix of the read's revcomp).
    mm(t) = rightanch(rows_f[0:t) @ pA) + rightanch(rows_r[0:rl-t) @ pB).
    pattern "rf": pA/pB are each piece's FIRST base; suffix mirror.

    Returns (best_t, mm, ok): (R, E)."""
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    R, L = rows_f.shape
    E = pA.shape[0]
    t = jnp.arange(L, dtype=jnp.int32)

    def right_anchor_mm(rows, p):
        """out[r, e, k] = mismatches of rows[r][0:k) right-anchored so its
        last char sits at genome position p[e]."""
        li = p[:, None] - (L - 1) + jnp.arange(L, dtype=jnp.int32)
        flank = jnp.where((li >= 0) & (li < n),
                          genome[jnp.clip(li, 0, n - 1)], jnp.int8(5))
        Y = _one_hot(flank)
        X = _one_hot(rows)
        dn = jax.lax.conv_dimension_numbers((E, 4, L), (R, 4, L),
                                            ("NCW", "OIW", "NCW"))
        match = jax.lax.conv_general_dilated(
            jnp.moveaxis(Y, -1, 1), jnp.moveaxis(X, -1, 1),
            window_strides=(1,), padding=((0, L - 1),),
            dimension_numbers=dn)          # (E, R, lag), lag = L - k
        lag = jnp.clip(L - t, 0, L - 1)[None, None, :]
        m = jnp.moveaxis(match, 0, 1).astype(jnp.int32)[
            jnp.arange(R)[:, None, None], jnp.arange(E)[None, :, None], lag]
        return t[None, None, :] - m       # (R, E, k)

    def left_anchor_mm(rows, p):
        """out[r, e, s] = mismatches of rows[r][L0-s:) left-anchored at
        p[e], expressed per suffix start index u = rl - s handled by caller;
        here indexed by the suffix START offset in the row."""
        ri = p[:, None] + jnp.arange(L, dtype=jnp.int32)
        flank = jnp.where((ri >= 0) & (ri < n),
                          genome[jnp.clip(ri, 0, n - 1)], jnp.int8(5))
        Y = _one_hot(flank)
        X = _one_hot(rows)
        dn2 = jax.lax.conv_dimension_numbers((R, 4, L), (E, 4, L),
                                             ("NCW", "OIW", "NCW"))
        match = jax.lax.conv_general_dilated(
            jnp.moveaxis(X, -1, 1), jnp.moveaxis(Y, -1, 1),
            window_strides=(1,), padding=((0, L - 1),),
            dimension_numbers=dn2)         # (R, E, lag), lag = start offset
        m = match.astype(jnp.int32)[
            jnp.arange(R)[:, None, None], jnp.arange(E)[None, :, None],
            jnp.clip(t, 0, L - 1)[None, None, :]]
        suf_len = lengths[:, None, None] - t[None, None, :]
        return suf_len - m                 # (R, E, start offset t)

    rl = lengths[:, None, None]
    if pattern == "fr":
        mmA = right_anchor_mm(rows_f, pA)                    # prefix len t
        mmB_pref = right_anchor_mm(rows_r, pB)               # prefix len s
        # s = rl - t: gather along k axis at rl - t
        idx = jnp.clip(rl - t[None, None, :], 0, L - 1)
        mmB = jnp.take_along_axis(mmB_pref, idx, axis=2)
        mm = mmA + mmB
    else:
        mmA = left_anchor_mm(rows_f, pA)                     # suffix from t
        mmB_suf = left_anchor_mm(rows_r, pB)                 # suffix from u
        idx = jnp.clip(rl - t[None, None, :], 0, L - 1)
        mmB = jnp.take_along_axis(mmB_suf, idx, axis=2)
        mm = mmA + mmB
    interior = (t[None, None, :] >= 3) & (t[None, None, :] <= rl - 3)
    big = jnp.int32(32767)
    mm = jnp.where(interior & ev_valid[None, :, None], mm, big)
    best = jnp.min(mm, axis=2)
    best_t = jnp.argmin(mm, axis=2).astype(jnp.int32)
    return best_t, best, best <= FR_MM


def find_fr_fusions(fm, gs, seg_tables, lengths_unused, params,
                    cap: int = 16384):
    """Host driver: returns list of dicts per pattern with unique events and
    per-read best candidates:
      {"pattern": "fr"|"rf", "read", "t", "posA", "posB", "mm"} arrays."""
    seg_pos, seg_mm, seg_valid = (jnp.asarray(x) for x in seg_tables)
    cuts = jnp.asarray(gs.cuts)
    lengths = jnp.asarray(gs.lengths)
    R = gs.rows // 2
    if R == 0:
        return []
    L = gs.readsg.shape[1]
    reads_f = jnp.asarray(gs.readsg[:R])
    reads_r = jnp.asarray(gs.readsg[R:])
    pairs = build_fr_pairs(seg_pos, seg_valid, cuts, lengths, cap)

    out = []
    max_events = 256
    for pattern, dirname in (("prefix", "fr"), ("suffix", "rf")):
        t, posA, posB, mm, valid = scan_fr_pairs(
            fm.genome, reads_f, reads_r, lengths[:R], pairs, L, pattern)
        valid = np.asarray(valid)
        if not valid.any():
            continue
        rd = np.asarray(pairs.read)[valid]
        tt = np.asarray(t)[valid]
        pa = np.asarray(posA)[valid]
        pb = np.asarray(posB)[valid]
        mmv = np.asarray(mm)[valid]

        # realign EVERY read against the unique discovered breakpoints —
        # reads whose short piece carries no mappable segment (no anchor
        # pair) still align across a known break, like segments mapping
        # juncs_db's fusion flank records (juncs_db.cpp:152)
        # a break seen from the revcomp read is the same break with the
        # pieces swapped — include swapped coords so twins realign too
        uniq = np.unique(np.concatenate(
            [np.stack([pa, pb], axis=1),
             np.stack([pb, pa], axis=1)]), axis=0)[:max_events]
        E = len(uniq)
        pA_d = jnp.asarray(uniq[:, 0], jnp.int32)
        pB_d = jnp.asarray(uniq[:, 1], jnp.int32)
        bt, bmm, ok = realign_fr_events(
            fm.genome, reads_f, reads_r, lengths[:R], pA_d, pB_d,
            jnp.ones(E, bool), dirname)
        bt, bmm, ok = np.asarray(bt), np.asarray(bmm), np.asarray(ok)
        seen = set(zip(rd.tolist(), tt.tolist(), pa.tolist(), pb.tolist()))
        add_r, add_t, add_a, add_b, add_m = [], [], [], [], []
        for r, e in zip(*np.nonzero(ok)):
            if dirname == "fr":
                epa = int(uniq[e, 0]) ; epb = int(uniq[e, 1])
                key = (int(r), int(bt[r, e]), epa - 0, epb)
                # the realigned split implies piece ends at the event coords
                ra_pa = epa
                ra_pb = epb
            else:
                ra_pa = int(uniq[e, 0])
                ra_pb = int(uniq[e, 1])
                key = (int(r), int(bt[r, e]), ra_pa, ra_pb)
            if key in seen:
                continue
            seen.add(key)
            add_r.append(int(r)); add_t.append(int(bt[r, e]))
            add_a.append(ra_pa); add_b.append(ra_pb)
            add_m.append(int(bmm[r, e]))
        if add_r:
            rd = np.concatenate([rd, np.array(add_r, rd.dtype)])
            tt = np.concatenate([tt, np.array(add_t, tt.dtype)])
            pa = np.concatenate([pa, np.array(add_a, pa.dtype)])
            pb = np.concatenate([pb, np.array(add_b, pb.dtype)])
            mmv = np.concatenate([mmv, np.array(add_m, mmv.dtype)])
        out.append(dict(pattern=dirname, read=rd, t=tt, posA=pa, posB=pb,
                        mm=mmv))
    return out
