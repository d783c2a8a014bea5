"""Realign reads across candidate events (junctions / deletions / insertions).

Replaces the reference's juncs_db flank-FASTA -> bowtie -> coordinate-rebase
loop (src/juncs_db.cpp:109 print_splice; src/bwt_map.cpp:885
SplicedSAMHitFactory) and tophat_reports' realign_reads
(src/tophat_reports.cpp:1231) with one batched device computation.

For event e with boundary (left | right) and a read placed so its first t
bases end at `left` and the rest resumes at `right`, the mismatch count
splits into a prefix term and a suffix term. Sweeping t is a cross-
correlation between the one-hot read and the one-hot genome flank, so the
whole (read x event x split) mismatch volume is two conv_general_dilated
calls — dense matrix-unit work instead of a per-candidate seed-and-extend
loop.

Precision: every product is formed from 0/1 one-hots in bfloat16 with
float32 accumulation. 0 and 1 are exact in bfloat16 and the match counts
are integers <= L, far below 2**24, so the counts are exact (tolerance 0)
whatever reduced-precision mode the matrix unit runs in.

Split semantics per kind:
  junction/deletion: read[0:t] ends at left; read[t:] starts at right
  insertion (ins_len=q): read[0:t] ends at left; read[t:t+q] is the inserted
  sequence (compared against the event's seq); read[t+q:] starts at left+1
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tophat_tpu.ops.splice import KIND_INSERTION

MAX_INS = 8  # inserted-sequence slot width


def _one_hot(codes, dtype):
    """(..., L) int8 codes -> (..., L, 4); pad/N/out-of-range rows are zero,
    which the count arithmetic turns into mismatches."""
    c = codes[..., None]
    return (c == jnp.arange(4, dtype=codes.dtype)).astype(dtype)


@partial(jax.jit, static_argnames=("max_mm",))
def realign_chunk(genome, readsg, lengths, ev_left, ev_right, ev_kind,
                  ev_ins_len, ev_ins_seq, ev_valid, max_mm: int):
    """Best split alignment of every read row against every event.

    readsg  : (R, L) genome-space read codes (-1 padded)
    ev_*    : (E,) event table arrays; ev_ins_seq (E, MAX_INS)
    Returns (best_t, mm, ok): (R, E) — leftmost split minimizing mismatches,
    its mismatch count (excluding inserted/deleted bases), and validity
    (mm <= max_mm, split interior, event valid).
    """
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    R, L = readsg.shape
    E = ev_left.shape[0]
    dt = jnp.bfloat16   # 0/1 one-hots: exact products, f32 accumulation

    X = _one_hot(readsg, dt)                                   # (R, L, 4)

    li = ev_left[:, None] - (L - 1) + jnp.arange(L, dtype=jnp.int32)
    flankL = jnp.where((li >= 0) & (li < n),
                       genome[jnp.clip(li, 0, n - 1)], jnp.int8(5))
    r_start = jnp.where(ev_kind == KIND_INSERTION, ev_left + 1, ev_right)
    ri = r_start[:, None] + jnp.arange(L, dtype=jnp.int32)
    flankR = jnp.where((ri >= 0) & (ri < n),
                       genome[jnp.clip(ri, 0, n - 1)], jnp.int8(5))
    YL = _one_hot(flankL, dt)                                  # (E, L, 4)
    YR = _one_hot(flankR, dt)

    dn = jax.lax.conv_dimension_numbers((E, 4, L), (R, 4, L),
                                        ("NCW", "OIW", "NCW"))
    # matchL[e, r, lag] = sum_u X[r, u] * YL[e, u + lag]; both convs take
    # bf16 0/1 operands with f32 accumulation, so the counts are exact
    matchL = jax.lax.conv_general_dilated(
        jnp.moveaxis(YL, -1, 1), jnp.moveaxis(X, -1, 1),
        window_strides=(1,), padding=((0, L - 1),), dimension_numbers=dn,
        preferred_element_type=jnp.float32)
    # matchR[r, e, lag] = sum_u X[r, u] * YR[e, u - lag]
    dn2 = jax.lax.conv_dimension_numbers((R, 4, L), (E, 4, L),
                                         ("NCW", "OIW", "NCW"))
    matchR = jax.lax.conv_general_dilated(
        jnp.moveaxis(X, -1, 1), jnp.moveaxis(YR, -1, 1),
        window_strides=(1,), padding=((0, L - 1),), dimension_numbers=dn2,
        preferred_element_type=jnp.float32)

    t = jnp.arange(L, dtype=jnp.int32)                         # split point
    q = ev_ins_len.astype(jnp.int32)[None, :, None]            # (1, E, 1)
    lag_l = jnp.clip(L - t, 0, L - 1)[None, None, :]
    mmL = t[None, None, :] - jnp.moveaxis(matchL, 0, 1).astype(jnp.int32)[
        jnp.arange(R)[:, None, None], jnp.arange(E)[None, :, None], lag_l]

    lag_r = jnp.clip(t[None, None, :] + q, 0, L - 1)
    mR = matchR.astype(jnp.int32)[
        jnp.arange(R)[:, None, None], jnp.arange(E)[None, :, None], lag_r]
    suf_len = lengths[:, None, None] - t[None, None, :] - q
    mmR = suf_len - mR

    # inserted-base mismatches vs the event's sequence (static unroll keeps
    # peak memory at one (R, E, L) buffer instead of MAX_INS of them)
    mm_ins = jnp.zeros((R, E, L), jnp.int32)
    for i in range(MAX_INS):
        rb = readsg[jnp.arange(R, dtype=jnp.int32)[:, None, None],
                    jnp.clip(t[None, None, :] + i, 0, L - 1)]  # (R, 1, L)
        sb = ev_ins_seq[None, :, i, None]                      # (1, E, 1)
        act = i < q
        mm_ins = mm_ins + (((rb != sb) | (rb >= 4) | (sb >= 4)) & act)

    mm = mmL + mmR + mm_ins
    interior = ((t[None, None, :] >= 1)
                & (t[None, None, :] + q <= lengths[:, None, None] - 1))
    big = jnp.int32(32767)
    mm = jnp.where(interior & ev_valid[None, :, None], mm, big)

    best = jnp.min(mm, axis=2)
    best_t = jnp.argmin(mm, axis=2).astype(jnp.int32)
    ok = best <= max_mm
    return best_t, jnp.where(ok, best, big), ok


def prepare_inputs(genome, readsg, ev_left, ev_right, ev_kind, ev_ins_seq,
                   q: int, L: int):
    """bf16 one-hot operands of realign_scan.

    Mirrors realign_chunk's flank construction: the left flank ends at
    ev_left; the right-hand target is the concatenation [inserted_seq (q) |
    flankR], flankR starting at ev_right (junction, deletion, fusion) or
    ev_left + 1 (insertion), so ONE lag slice covers both the inserted
    bases and the suffix. Returns X (R, L*4) and the zero-padded flank
    volumes YLpadT, YCpadT (2L*4, E), base axis first so that each split's
    lag is a slice of the leading axis."""
    genome = jnp.asarray(genome)
    n = genome.shape[0]
    E = ev_left.shape[0]
    R = readsg.shape[0]

    X = _one_hot(jnp.asarray(readsg, jnp.int32), jnp.bfloat16)

    li = ev_left[:, None] - (L - 1) + jnp.arange(L, dtype=jnp.int32)
    flankL = jnp.where((li >= 0) & (li < n),
                       genome[jnp.clip(li, 0, n - 1)].astype(jnp.int32), 5)
    r_start = jnp.where(ev_kind == KIND_INSERTION, ev_left + 1, ev_right)
    ri = r_start[:, None] + jnp.arange(L - q, dtype=jnp.int32)
    flankR = jnp.where((ri >= 0) & (ri < n),
                       genome[jnp.clip(ri, 0, n - 1)].astype(jnp.int32), 5)
    seq = jnp.asarray(ev_ins_seq[:, :q], jnp.int32) if q else jnp.zeros(
        (E, 0), jnp.int32)
    combined = jnp.concatenate([seq, flankR], axis=1)      # (E, L)

    zL = jnp.zeros((E, L, 4), jnp.bfloat16)
    YLpad = jnp.concatenate([_one_hot(flankL, jnp.bfloat16), zL], axis=1)
    YCpad = jnp.concatenate([zL, _one_hot(combined, jnp.bfloat16)], axis=1)
    return (X.reshape(R, -1), YLpad.reshape(E, -1).T,
            YCpad.reshape(E, -1).T)


@partial(jax.jit, static_argnames=("L", "q", "max_mm"))
def realign_scan(X, YLpadT, YCpadT, lengths, *, L: int, q: int,
                 max_mm: int):
    """realign_chunk's result as a scan over split points t: each step is
    two bf16 matmuls against lag-shifted flank slices, folded straight into
    running (best, best_t), so memory traffic is O(R*E) per step instead
    of the conv path's materialized O(R*E*L) volumes. Inputs come from
    prepare_inputs; every event of a call has insertion length q.

      mm(t) = [t - matchL(lag L-t)] + [(len - t) - matchC(lag L-t)]

    over the interior splits 1 <= t <= len - 1 - q."""
    R = X.shape[0]
    E = YLpadT.shape[1]
    lens = lengths[:, None].astype(jnp.int32)
    big = jnp.float32(32767.0)

    def body(carry, t):
        best, bestt = carry
        sl = (L - t) * 4
        yl = jax.lax.dynamic_slice_in_dim(YLpadT, sl, L * 4, axis=0)
        yc = jax.lax.dynamic_slice_in_dim(YCpadT, sl, L * 4, axis=0)
        # 0/1 bf16 operands, f32 accumulation: exact (module docstring)
        matchL = jax.lax.dot_general(
            X, yl, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        matchC = jax.lax.dot_general(
            X, yc, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        mm = (t.astype(jnp.float32) - matchL) + (
            (lens - t).astype(jnp.float32) - matchC)
        interior = (t >= 1) & (t + q <= lens - 1)
        mm = jnp.where(interior, mm, big)
        upd = mm < best
        return (jnp.where(upd, mm, best), jnp.where(upd, t, bestt)), None

    init = (jnp.full((R, E), big, jnp.float32),
            jnp.zeros((R, E), jnp.int32))
    (best, bestt), _ = jax.lax.scan(
        body, init, jnp.arange(1, L, dtype=jnp.int32))
    besti = best.astype(jnp.int32)
    ok = besti <= max_mm
    return bestt, jnp.where(ok, besti, jnp.int32(32767)), ok


def realign_events(genome, readsg, lengths, events, max_mm: int,
                   chunk: int = 128):
    """Host wrapper: chunk the event table to bound device memory.

    events: dict of numpy arrays (left, right, kind, ins_len, ins_seq,
    valid). Returns (best_t, mm, ok) as (R, E) numpy arrays.

    Routing: with an active mesh, the conv path realign_chunk (it
    row-shards over the reads axis); otherwise realign_scan, grouped by
    insertion length."""
    E = len(events["left"])
    R = readsg.shape[0]
    if E == 0:
        return (np.zeros((R, 0), np.int32), np.zeros((R, 0), np.int32),
                np.zeros((R, 0), bool))
    from tophat_tpu.parallel import auto

    if auto.active() is None:
        return _realign_events_grouped(genome, readsg, lengths, events,
                                       max_mm)
    # multi-device: rows sharded over the mesh's reads axis, events + genome
    # replicated (parallel/auto.py) — the realignment analog of the
    # reference's per-thread read ranges (tophat_reports.cpp:1231)
    (readsg_d, lengths_d), nrows = auto.shard_rows(readsg, lengths)
    genome_d = auto.replicated(genome)
    outs_t, outs_mm, outs_ok = [], [], []
    for s in range(0, E, chunk):
        e = min(s + chunk, E)
        pad = chunk - (e - s)
        pick = lambda a: np.concatenate(
            [a[s:e], np.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a[s:e]
        bt, mm, ok = realign_chunk(
            genome_d, readsg_d, lengths_d,
            jnp.asarray(pick(events["left"])), jnp.asarray(pick(events["right"])),
            jnp.asarray(pick(events["kind"])), jnp.asarray(pick(events["ins_len"])),
            jnp.asarray(pick(events["ins_seq"])),
            jnp.asarray(pick(events["valid"].astype(bool))), max_mm=max_mm)
        outs_t.append(np.asarray(bt)[:nrows, : e - s])
        outs_mm.append(np.asarray(mm)[:nrows, : e - s])
        outs_ok.append(np.asarray(ok)[:nrows, : e - s])
    return (np.concatenate(outs_t, 1), np.concatenate(outs_mm, 1),
            np.concatenate(outs_ok, 1))


@partial(jax.jit, static_argnames=("cap",))
def _pack_sparse(bt, mm, ok, n_ev, cap: int):
    """Device-side compaction of a realign (R, E) result to the flat ok
    entries (row, ev, t, mm) — the host boundary transfers ~n_ok records
    instead of three dense (R, E) tables. Event columns >= n_ev are shape
    padding and masked out. Returns (row, ev, t, mm, count, overflow)."""
    R, E = ok.shape
    ok = ok & (jnp.arange(E, dtype=jnp.int32) < n_ev)[None, :]
    flat = ok.reshape(-1)
    rows = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[:, None],
                            (R, E)).reshape(-1)
    evs = jnp.broadcast_to(jnp.arange(E, dtype=jnp.int32)[None, :],
                           (R, E)).reshape(-1)
    csum = jnp.cumsum(flat.astype(jnp.int32))
    n = csum[-1]
    keep = flat & (csum <= cap)
    slot = jnp.where(keep, csum - 1, cap)
    pick = lambda a: jnp.zeros(cap + 1, jnp.int32).at[slot].set(
        jnp.where(keep, a, 0))[:cap]
    return (pick(rows), pick(evs), pick(bt.reshape(-1)),
            pick(mm.reshape(-1)), n, n > cap)


def _realign_events_grouped(genome, readsg, lengths, events, max_mm: int,
                            sparse: bool = False):
    """Route realignment through realign_scan, one call per distinct
    insertion length (the scan's lag slice assumes one q per call).

    sparse=False: dense (R, E) host tables (best_t, mm, ok).
    sparse=True: flat (rows, evs, t, mm) numpy arrays of the ok entries,
    packed on device before the transfer."""
    R, L = readsg.shape
    E = len(events["left"])
    if sparse:
        acc = ([], [], [], [])
    else:
        best_t = np.zeros((R, E), np.int32)
        mm = np.full((R, E), 32767, np.int32)
        ok = np.zeros((R, E), bool)

    valid = np.asarray(events["valid"]).astype(bool)
    kinds = np.asarray(events["kind"])
    ilen = np.where(kinds == KIND_INSERTION,
                    np.asarray(events["ins_len"]), 0).astype(np.int32)
    lengths_d = jnp.asarray(lengths)
    for q in np.unique(ilen):
        idx = np.nonzero(ilen == q)[0]
        # pad the event group to a power of two: successive batches with
        # slightly different discovered-event counts must share compiled
        # shapes (a mid-bench recompile costs more than the realign)
        npad = (1 << max(3, int(len(idx) - 1).bit_length())) - len(idx)
        idx_p = np.concatenate([idx, np.repeat(idx[:1], npad)])
        X, YL, YC = prepare_inputs(
            genome, readsg, jnp.asarray(events["left"][idx_p]),
            jnp.asarray(events["right"][idx_p]), jnp.asarray(kinds[idx_p]),
            np.asarray(events["ins_seq"])[idx_p], int(q), L)
        bt, m, o = realign_scan(X, YL, YC, lengths_d, L=L, q=int(q),
                                max_mm=max_mm)
        k = len(idx)
        if sparse:
            cap = max(4 * R, 4096)
            rj, ej, tj, mj, n, ovf = _pack_sparse(bt, m, o,
                                                  jnp.int32(k), cap)
            if bool(ovf):   # rare repeat blowup: take the dense tables
                o_np = np.asarray(o)[:, :k] & valid[None, idx]
                rr, ee = np.nonzero(o_np)
                acc[0].append(rr.astype(np.int32))
                acc[1].append(idx[ee].astype(np.int32))
                acc[2].append(np.asarray(bt)[:, :k][rr, ee])
                acc[3].append(np.asarray(m)[:, :k][rr, ee])
                continue
            nk = int(n)
            rj = np.asarray(rj)[:nk]
            ej = np.asarray(ej)[:nk]
            tj = np.asarray(tj)[:nk]
            mj = np.asarray(mj)[:nk]
            vsel = valid[idx[ej]]
            acc[0].append(rj[vsel])
            acc[1].append(idx[ej[vsel]].astype(np.int32))
            acc[2].append(tj[vsel])
            acc[3].append(mj[vsel])
        else:
            best_t[:, idx] = np.asarray(bt)[:, :k]
            mm[:, idx] = np.asarray(m)[:, :k]
            ok[:, idx] = np.asarray(o)[:, :k]
    if sparse:
        cat = lambda xs: (np.concatenate(xs) if xs
                          else np.zeros(0, np.int32))
        return tuple(cat(a) for a in acc)
    ok &= valid[None, :]
    return best_t, mm, ok


def realign_events_sparse(genome, readsg, lengths, events, max_mm: int,
                          chunk: int = 128):
    """Flat-result realignment for the production candidate path: returns
    (rows, evs, best_t, mm) numpy arrays of the passing (row, event)
    pairs only. Single-device runs pack on device (_pack_sparse); the
    mesh path reuses realign_events' sharded dense tables and flattens
    on host (they are already host arrays there)."""
    from tophat_tpu.parallel import auto

    R = readsg.shape[0]
    E = len(events["left"])
    if E == 0 or R == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy(), z.copy(), z.copy()
    if auto.active() is not None:
        bt, mm, ok = realign_events(genome, readsg, lengths, events,
                                    max_mm, chunk=chunk)
        rr, ee = np.nonzero(ok)
        return (rr.astype(np.int32), ee.astype(np.int32),
                bt[rr, ee].astype(np.int32), mm[rr, ee].astype(np.int32))
    return _realign_events_grouped(genome, readsg, lengths, events,
                                   max_mm, sparse=True)
