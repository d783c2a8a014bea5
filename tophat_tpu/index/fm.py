"""FM-index: build on host, search on the device.

This is the device-side replacement for the external Bowtie FM-index
(reference: src/tophat.py:2286-2353 drives `bowtie2` as a subprocess; the
index itself lives in .ebwt/.bt2 files). Here the index is a set of device
arrays designed for batched rank queries:

  packed_bwt : uint32[ceil((n+1)/16)]    BWT(T$), 2-bit codes, 16 per word
  occ_ck     : int32[nblocks+1, 4]       Occ checkpoints every OCC_BLOCK bases
  C          : int32[5]                  C[c] = 1 + #{symbols < c in T}
  sa         : int32[n+1]                suffix array (full; sampled variant
                                         planned behind resolve())
  genome     : int8[n]                   original codes incl. N=4, for
                                         verification gathers
  primary    : int32[]                   row of the sentinel in the BWT

N bases are mapped to A in the FM text; candidate verification against
`genome` (ops/verify.py) re-counts them as mismatches, so N regions can never
produce a reported alignment they shouldn't.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

from tophat_tpu.index.fasta import Genome
from tophat_tpu.index.suffix import bwt_from_sa, suffix_array

OCC_BLOCK = 128  # bases per Occ checkpoint block
WORDS_PER_BLOCK = OCC_BLOCK // 16


_PACK_CHUNK = 1 << 24  # bases per packing/counting chunk (blocked builds:
#                        scratch stays O(chunk), not O(genome) — the
#                        whole-genome diet VERDICT r2 called for)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack int8 2-bit codes (values 0..3) into uint32 words, 16 per word,
    code i at bits [2*(i%16), 2*(i%16)+1]. Blocked: peak scratch is one
    chunk's expansion, not 8 B/base."""
    n = codes.shape[0]
    nwords = (n + 15) // 16
    out = np.empty(nwords, np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    step = _PACK_CHUNK  # multiple of 16
    for s in range(0, max(n, 1), step):
        e = min(s + step, n)
        w0, w1 = s // 16, (e + 15) // 16
        padded = np.zeros((w1 - w0) * 16, dtype=np.uint32)
        padded[: e - s] = codes[s:e].astype(np.uint32)
        out[w0:w1] = np.bitwise_or.reduce(
            padded.reshape(-1, 16) << shifts, axis=1).astype(np.uint32)
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FMIndex:
    packed_bwt: Any  # uint32[(n+1+15)//16]
    occ_ck: Any      # int32[nblocks+1, 4]
    C: Any           # int32[5]
    sa: Any          # int32[n+1]
    genome: Any      # int8[n]
    primary: Any     # int32[] scalar
    # word-packed genome for fast verification: 2-bit codes (N stored as 0)
    # and a 1-bit N mask, both little-endian within each uint32. When
    # pg_dual, an 8-base-shifted second pack is APPENDED (words cover
    # [8+16j, 24+16j)): any L-window with L <= 16*ceil(L/16) - 7 then
    # needs only ceil(L/16) word gathers — the copy whose alignment puts
    # the window start in the low half of a word always exists. Existing
    # consumers are unaffected: in-bounds candidates never index past the
    # primary region, and out-of-bounds lanes were already masked.
    packed_genome: Any  # uint32[ceil(n/16) (+ ceil((n-8)/16) if dual)]
    n_mask: Any         # uint32[ceil(n/32)]
    # mid-checkpoints: occ_mid[k, c] = #c in bwt[(k//4)*128 : k*32) — the
    # 32-base prefix within each 128-base block, so a rank() needs only 2
    # packed words + 1 byte instead of 8 words (uint8: counts <= 96)
    occ_mid: Any        # uint8[ceil((n+1)/32), 4] or uint8[0, 4]
    # optional k-mer -> SA-interval seed table (skips the first k backward
    # search steps; size 2 * 4^k int32, independent of genome size)
    kmer_lo: Any        # int32[4^k] or int32[0]
    kmer_hi: Any        # int32[4^k] or int32[0]
    # sampled-SA structures (sa_rate > 0): text-order sampling — rows whose
    # SA value is divisible by sa_rate are marked; resolution LF-walks to
    # the nearest marked row (<= sa_rate-1 steps). Cuts SA memory by
    # sa_rate at the cost of walk steps; `sa` is empty when sampled.
    sa_marks: Any       # uint32[ceil((n+1)/32)] or uint32[0]
    sa_mark_ck: Any     # int32[nblocks+1] rank checkpoints per 128 rows
    sa_mark_mid: Any    # uint8[ceil((n+1)/32)] marked-count within block
    sa_samples: Any     # int32[#marked] SA values of marked rows, row order
    n: int = dataclasses.field(metadata=dict(static=True))
    kmer_k: int = dataclasses.field(metadata=dict(static=True), default=0)
    sa_rate: int = dataclasses.field(metadata=dict(static=True), default=0)
    # genomes without any N skip the N-mask gather in verification
    # (one of the two hottest gathers at chromosome scale)
    has_n: bool = dataclasses.field(metadata=dict(static=True), default=True)
    # packed_genome carries the appended 8-shifted copy (see above)
    pg_dual: bool = dataclasses.field(metadata=dict(static=True),
                                      default=False)

    @property
    def nbytes(self) -> int:
        """Total bytes of all table leaves — the per-device HBM cost of
        replicating this index (drives the range-sharding decision in
        parallel/auto.configure_genome_axis)."""
        return sum(np.asarray(leaf).nbytes
                   for leaf in jax.tree_util.tree_leaves(self))

    def device_put(self, sharding=None) -> "FMIndex":
        put = (lambda x: jax.device_put(x, sharding)) if sharding else jax.device_put
        return dataclasses.replace(
            self, packed_bwt=put(self.packed_bwt), occ_ck=put(self.occ_ck),
            occ_mid=put(self.occ_mid),
            C=put(self.C), sa=put(self.sa), genome=put(self.genome),
            primary=put(self.primary), packed_genome=put(self.packed_genome),
            n_mask=put(self.n_mask), kmer_lo=put(self.kmer_lo),
            kmer_hi=put(self.kmer_hi), sa_marks=put(self.sa_marks),
            sa_mark_ck=put(self.sa_mark_ck),
            sa_mark_mid=put(self.sa_mark_mid),
            sa_samples=put(self.sa_samples))

    def save(self, path: str) -> None:
        np.savez(
            path, packed_bwt=np.asarray(self.packed_bwt),
            occ_ck=np.asarray(self.occ_ck),
            occ_mid=np.asarray(self.occ_mid), C=np.asarray(self.C),
            sa=np.asarray(self.sa), genome=np.asarray(self.genome),
            primary=np.asarray(self.primary),
            packed_genome=np.asarray(self.packed_genome),
            n_mask=np.asarray(self.n_mask),
            kmer_lo=np.asarray(self.kmer_lo),
            kmer_hi=np.asarray(self.kmer_hi),
            sa_marks=np.asarray(self.sa_marks),
            sa_mark_ck=np.asarray(self.sa_mark_ck),
            sa_mark_mid=np.asarray(self.sa_mark_mid),
            sa_samples=np.asarray(self.sa_samples),
            n=self.n, kmer_k=self.kmer_k, sa_rate=self.sa_rate,
            has_n=self.has_n, pg_dual=self.pg_dual)

    @staticmethod
    def load(path: str) -> "FMIndex":
        z = np.load(path)
        get = lambda k, d: z[k] if k in z.files else d
        return FMIndex(
            packed_bwt=z["packed_bwt"], occ_ck=z["occ_ck"],
            occ_mid=get("occ_mid", np.zeros((0, 4), np.uint8)), C=z["C"],
            sa=z["sa"], genome=z["genome"], primary=z["primary"][()],
            packed_genome=z["packed_genome"], n_mask=z["n_mask"],
            kmer_lo=z["kmer_lo"], kmer_hi=z["kmer_hi"],
            sa_marks=get("sa_marks", np.zeros(0, np.uint32)),
            sa_mark_ck=get("sa_mark_ck", np.zeros(0, np.int32)),
            sa_mark_mid=get("sa_mark_mid", np.zeros(0, np.uint8)),
            sa_samples=get("sa_samples", np.zeros(0, np.int32)),
            n=int(z["n"][()]), kmer_k=int(z["kmer_k"][()]),
            sa_rate=int(get("sa_rate", np.int32(0))[()]
                        if "sa_rate" in z.files else 0),
            has_n=bool(z["has_n"][()]) if "has_n" in z.files
            else bool(np.any(z["n_mask"])),
            pg_dual=bool(z["pg_dual"][()]) if "pg_dual" in z.files
            else False)


def pack_1bit(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean array into uint32 words, bit i%32 of word i//32.
    Blocked like pack_2bit."""
    n = bits.shape[0]
    nwords = (n + 31) // 32
    out = np.empty(nwords, np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    step = _PACK_CHUNK  # multiple of 32
    for s in range(0, max(n, 1), step):
        e = min(s + step, n)
        w0, w1 = s // 32, (e + 31) // 32
        padded = np.zeros((w1 - w0) * 32, dtype=np.uint32)
        padded[: e - s] = bits[s:e].astype(np.uint32)
        out[w0:w1] = np.bitwise_or.reduce(
            padded.reshape(-1, 32) << shifts, axis=1).astype(np.uint32)
    return out


def _sub_block_counts(arr: np.ndarray, nblocks: int, sub: int,
                      classes: int):
    """Per-`sub`-base-window class counts of an int8 array, blocked.

    Returns (nblocks * (OCC_BLOCK // sub), classes) uint8 counts —
    the shared scratch-free core of the Occ / SA-mark checkpoint builds.
    """
    m = arr.shape[0]
    per = OCC_BLOCK // sub
    out = np.zeros((nblocks * per, classes), np.uint8)
    step = _PACK_CHUNK  # multiple of OCC_BLOCK
    for s in range(0, max(m, 1), step):
        e = min(s + step, m)
        r0, r1 = s // sub, (e + sub - 1) // sub
        seg = np.full((r1 - r0) * sub, classes, arr.dtype)  # pad value is
        seg[: e - s] = arr[s:e]                             # outside [0, C)
        seg2 = seg.reshape(-1, sub)
        for c in range(classes):
            out[r0:r1, c] = (seg2 == c).sum(axis=1).astype(np.uint8)
    return out


def _build_kmer_table(text: np.ndarray, sa: np.ndarray, k: int):
    """SA interval [lo, hi) of every k-mer, exploiting that fixed-length
    prefixes appear in sorted, contiguous runs along the suffix array."""
    n = text.shape[0]
    if n < k:
        z = np.zeros(4 ** k, np.int32)
        return z, z.copy()
    try:
        from tophat_tpu.native import sais

        kv = sais.kmer_vals(text, sa, k)   # threaded single pass
        lo, hi = sais.kmer_table(kv, k)    # sequential interval pass
        return lo, hi
    except Exception:
        v = np.zeros(n - k + 1, dtype=np.int64)
        for j in range(k):
            v = v * 4 + text[j: n - k + 1 + j]
        rows = np.nonzero(sa <= n - k)[0]
        vals_sorted = v[sa[rows]]      # non-decreasing along SA order
    cnt = np.bincount(vals_sorted, minlength=4 ** k).astype(np.int32)
    first = np.concatenate([[0], np.cumsum(cnt[:-1])])
    lo = np.where(cnt > 0,
                  rows[np.minimum(first, len(rows) - 1)], 0).astype(np.int32)
    return lo, lo + cnt


def _occ_tables(bwt: np.ndarray, m: int):
    """Occ checkpoints + 32-base mid-checkpoints for a BWT (blocked
    scratch). Returns (occ_ck int32[nblocks+1, 4], occ_mid uint8)."""
    nblocks = (m + OCC_BLOCK - 1) // OCC_BLOCK
    per_sub = _sub_block_counts(bwt, nblocks, 32, 4)
    per_sub = per_sub.reshape(nblocks, OCC_BLOCK // 32, 4)
    per_block = per_sub.sum(axis=1, dtype=np.int64)
    occ_ck = np.zeros((nblocks + 1, 4), dtype=np.int32)
    occ_ck[1:] = np.cumsum(per_block, axis=0).astype(np.int32)
    occ_mid = np.zeros_like(per_sub)
    occ_mid[:, 1:] = np.cumsum(per_sub, axis=1, dtype=np.int64)[
        :, :-1].astype(np.uint8)
    occ_mid = np.concatenate([occ_mid.reshape(-1, 4),
                              np.zeros((4, 4), np.uint8)]).astype(np.uint8)
    return occ_ck, occ_mid


def ensure_dual_pack(fm: "FMIndex") -> "FMIndex":
    """Upgrade a legacy (non-dual) index in memory: append the 8-shifted
    genome pack so verification uses W instead of W+1 word gathers.
    ~13 s/Gbp of host packing, once per load."""
    if fm.pg_dual:
        return fm
    text = np.where(np.asarray(fm.genome) == 4, 0,
                    np.asarray(fm.genome)).astype(np.int8)
    return dataclasses.replace(
        fm, packed_genome=np.concatenate(
            [np.asarray(fm.packed_genome), pack_2bit(text[8:])]),
        pg_dual=True)


def host_codes(fm) -> np.ndarray:
    """Host numpy view of an index's genome codes. Index-like views used
    by the grouped pipeline carry a `genome_host` alongside a
    device-resident `genome`, so host-side consumers (chains, coverage,
    butterfly) never pull a multi-GB device array back over the link."""
    gh = getattr(fm, "genome_host", None)
    return gh if gh is not None else np.asarray(fm.genome)


def default_kmer_k(n: int) -> int:
    """Seed-table k for an in-process index build: large enough that
    k-mer SA intervals are O(1) wide on an n-base text (and that the
    variant split-pair family in ops/beam.py can run), small enough that
    the 2 * 4^k int32 table stays a sliver of the index itself. 0 below
    the beam threshold — tiny genomes search fine without a table."""
    if n < (1 << 21):
        return 0
    return int(np.clip(int(np.log(max(n, 4)) / np.log(4)) - 1, 8, 14))


def build_fm_index(genome: Genome | np.ndarray,
                   kmer_k: int = 0, sa_rate: int = 0,
                   sa: np.ndarray | None = None) -> FMIndex:
    """Build the FM-index of a genome's forward strand on the host.

    Reverse-strand alignment is done by searching the reverse complement of
    the read against this same index (no second index needed).
    kmer_k > 0 additionally builds the k-mer SA-interval seed table.
    sa_rate > 0 stores a text-order-sampled SA (1/sa_rate of the values)
    instead of the full array — see FMIndex field docs.
    sa: precomputed suffix array of text (N->A) with sentinel — lets
    several table variants (different kmer_k / sa_rate design points)
    build from ONE SA-IS pass, the dominant build cost at genome scale.

    (Historical note: rounds 3-4 optionally built bowtie-style mirror
    tables of the reversed text here; the split-pair mismatch case is
    now covered by k-mer-table variant enumeration on the forward index
    alone — ops/beam.py — so the second SA-IS pass is gone.)"""
    codes = genome.codes if isinstance(genome, Genome) else np.asarray(genome)
    codes = codes.astype(np.int8)
    text = np.where(codes == 4, 0, codes).astype(np.int8)  # N -> A in FM text
    n = text.shape[0]

    if sa is None:
        sa = suffix_array(text)
    else:
        sa = np.asarray(sa)
        assert sa.shape[0] == n + 1, "precomputed SA length mismatch"
    bwt, primary = bwt_from_sa(text, sa)
    m = n + 1

    # Occ checkpoints: occ_ck[b, c] = #occurrences of c in bwt[0 : b*OCC_BLOCK)
    # (the sentinel row's stored 0 is counted here; rank() subtracts it).
    # Blocked: per-32-base counts in uint8 (1 B/base scratch), not the old
    # 16 B/base one-hot — required at whole-genome scale.
    occ_ck, occ_mid = _occ_tables(bwt, m)

    # C[c] = 1 (sentinel) + #symbols < c in the text
    counts = np.bincount(text, minlength=4)[:4]
    C = np.zeros(5, dtype=np.int32)
    C[1:] = np.cumsum(counts)
    C += 1
    C[0] = 1

    if kmer_k:
        kmer_lo, kmer_hi = _build_kmer_table(text, sa, kmer_k)
    else:
        kmer_lo = kmer_hi = np.zeros(0, np.int32)

    if sa_rate:
        marked = (sa % sa_rate) == 0
        sa_marks = pack_1bit(marked)
        nb = (m + 127) // 128
        # per-32-row marked counts, blocked (class 1 of the int8 view)
        per_sub = _sub_block_counts(marked.astype(np.int8), nb, 32,
                                    2)[:, 1].reshape(nb, 4)
        csum = np.cumsum(per_sub.sum(axis=1, dtype=np.int64))
        sa_mark_ck = np.concatenate([[0], csum]).astype(np.int32)
        # per-32-row mid counts (exclusive prefix within block, +4 pad rows)
        mid = np.zeros_like(per_sub)
        mid[:, 1:] = np.cumsum(per_sub, axis=1, dtype=np.int64)[
            :, :-1].astype(np.uint8)
        sa_mark_mid = np.concatenate(
            [mid.reshape(-1), np.zeros(4, np.uint8)]).astype(np.uint8)
        sa_samples = sa[marked].astype(np.int32)
        sa_store = np.zeros(0, np.int32)
    else:
        sa_marks = np.zeros(0, np.uint32)
        sa_mark_ck = np.zeros(0, np.int32)
        sa_mark_mid = np.zeros(0, np.uint8)
        sa_samples = np.zeros(0, np.int32)
        sa_store = sa.astype(np.int32)

    return FMIndex(
        packed_bwt=pack_2bit(bwt), occ_ck=occ_ck, occ_mid=occ_mid, C=C,
        sa=sa_store, genome=codes,
        primary=np.int32(primary),
        packed_genome=np.concatenate([pack_2bit(text),
                                      pack_2bit(text[8:])]),
        pg_dual=True, n_mask=pack_1bit(codes == 4),
        kmer_lo=kmer_lo, kmer_hi=kmer_hi,
        sa_marks=sa_marks, sa_mark_ck=sa_mark_ck, sa_mark_mid=sa_mark_mid,
        sa_samples=sa_samples, has_n=bool((codes == 4).any()),
        n=n, kmer_k=kmer_k, sa_rate=sa_rate)
