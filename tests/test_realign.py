"""Event realignment: the split-scan path (realign_scan) against the conv
reference (realign_chunk), and the sparse result against the dense one."""

import numpy as np
import pytest

import jax.numpy as jnp

from tophat_tpu.index.fasta import genome_from_seqs
from tophat_tpu.ops.events import (MAX_INS, prepare_inputs, realign_chunk,
                                   realign_events, realign_events_sparse,
                                   realign_scan)
from tophat_tpu.ops.splice import KIND_INSERTION, KIND_JUNCTION


def _genome(rng, n):
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[n // 2: n // 2 + 40] = 4          # an N run inside the genome
    g = genome_from_seqs([("c", "".join("ACGTN"[c] for c in codes))])
    return g.codes


def _planted(rng, codes, R, E, L, q):
    """Events of insertion length q (junctions when q == 0) and R reads,
    most planted across a random event (every third with a mismatch),
    some carrying Ns, some shorter than L."""
    n = len(codes)
    lefts = rng.integers(L, n - 400 - L, E).astype(np.int32)
    seqs = np.full((E, MAX_INS), -1, np.int8)
    if q == 0:
        rights = (lefts + rng.integers(60, 300, E)).astype(np.int32)
        kinds = np.full(E, KIND_JUNCTION, np.int8)
    else:
        rights = lefts + 1
        kinds = np.full(E, KIND_INSERTION, np.int8)
        seqs[:, :q] = rng.integers(0, 4, (E, q))
    lefts[0] = 3                    # left flank runs off the genome start
    reads = np.full((R, L), -1, np.int8)
    lengths = np.full(R, L, np.int32)
    for i in range(R):
        e = int(rng.integers(0, E))
        ln = L if i % 5 else L - int(rng.integers(1, L // 4))
        t = int(rng.integers(1, ln - 1 - q))
        pre = codes[max(lefts[e] - t + 1, 0): lefts[e] + 1]
        start = rights[e] if q == 0 else lefts[e] + 1
        read = np.concatenate([pre, seqs[e, :q],
                               codes[start: start + ln - len(pre) - q]])
        if i % 3 == 0:
            p = int(rng.integers(0, ln))
            read[p] = (read[p] + 1) % 4
        if i % 7 == 0:
            read[int(rng.integers(0, ln))] = 4
        reads[i, :ln] = read[:ln]
        lengths[i] = ln
    ins_len = np.full(E, q, np.int8)
    return reads, lengths, lefts, rights, kinds, ins_len, seqs


def check_scan_matches_chunk(rng, n, R, E, L, q, max_mm=2):
    """realign_scan and realign_chunk agree on every (read, event) entry;
    returns the number of passing entries."""
    codes = _genome(rng, n)
    reads, lengths, lefts, rights, kinds, ins_len, seqs = _planted(
        rng, codes, R, E, L, q)
    genome = jnp.asarray(codes)
    ref = realign_chunk(
        genome, jnp.asarray(reads), jnp.asarray(lengths),
        jnp.asarray(lefts), jnp.asarray(rights), jnp.asarray(kinds),
        jnp.asarray(ins_len), jnp.asarray(seqs), jnp.ones(E, bool),
        max_mm=max_mm)
    X, YL, YC = prepare_inputs(genome, reads, jnp.asarray(lefts),
                               jnp.asarray(rights), jnp.asarray(kinds),
                               seqs, q, L)
    got = realign_scan(X, YL, YC, jnp.asarray(lengths), L=L, q=q,
                       max_mm=max_mm)
    for name, a, b in zip(("best_t", "mm", "ok"), ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    return int(np.asarray(ref[2]).sum())


@pytest.mark.parametrize("q", [0, 3])
def test_realign_scan_matches_chunk(rng, q):
    n_ok = check_scan_matches_chunk(rng, 4000, R=96, E=64, L=32, q=q)
    assert n_ok >= 80  # the planted reads really aligned


@pytest.mark.gpu
@pytest.mark.parametrize("q", [0, 3])
def test_realign_scan_matches_chunk_full_width(rng, q):
    """Production shape on the card (R=16384, E=128, L=100): the bf16
    products must stay exact under the GPU's matrix units."""
    n_ok = check_scan_matches_chunk(rng, 1 << 20, R=16384, E=128, L=100,
                                    q=q)
    assert n_ok >= 16384 * 9 // 10


def test_realign_events_sparse_matches_dense(rng):
    """Mixed event kinds and insertion lengths: the device-packed sparse
    result lists exactly the dense tables' passing entries."""
    L, R = 32, 80
    codes = _genome(rng, 6000)
    parts = [_planted(rng, codes, R // 2, 24, L, q) for q in (0, 2)]
    reads = np.concatenate([p[0] for p in parts])
    lengths = np.concatenate([p[1] for p in parts])
    events = dict(left=np.concatenate([p[2] for p in parts]),
                  right=np.concatenate([p[3] for p in parts]),
                  kind=np.concatenate([p[4] for p in parts]),
                  ins_len=np.concatenate([p[5] for p in parts]),
                  ins_seq=np.concatenate([p[6] for p in parts]),
                  valid=np.ones(48, bool))
    events["valid"][5] = False
    bt, mm, ok = realign_events(codes, reads, lengths, events, max_mm=2)
    rows, evs, t, m = realign_events_sparse(codes, reads, lengths, events,
                                            max_mm=2)
    got = sorted(zip(rows.tolist(), evs.tolist(), t.tolist(), m.tolist()))
    rr, ee = np.nonzero(ok)
    exp = sorted(zip(rr.tolist(), ee.tolist(), bt[rr, ee].tolist(),
                     mm[rr, ee].tolist()))
    assert got == exp
    assert len(exp) >= R * 3 // 4 and not ok[:, 5].any()
