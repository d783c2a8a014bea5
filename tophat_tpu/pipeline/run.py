"""End-to-end pipeline: the spliced_alignment + compile_reports flow of the
reference driver (src/tophat.py:3428 spliced_alignment, :2665
compile_reports) as in-process functions.

Stage order mirrors the reference semantically:
  prep -> full-read genome alignment -> IUM segmentation -> segment mapping
  -> junction/indel discovery (joint across mates) -> event realignment ->
  pass-1 stats + filter -> pass-2 selection -> outputs
but all "files between stages" are arrays in memory and all heavy loops are
device batches.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np

from tophat_tpu.index.fasta import Genome, revcomp
from tophat_tpu.index.fm import FMIndex, build_fm_index, host_codes
from tophat_tpu.io.fastq import ReadBatch, batch_reads, read_all
from tophat_tpu.ops.align import Alignments, align_reads
from tophat_tpu.ops.events import realign_events_sparse
from tophat_tpu.pipeline.juncs import discover_events, merge_events
from tophat_tpu.pipeline.params import Params
from tophat_tpu.pipeline.prep import prep_filter
from tophat_tpu.pipeline.report import (accumulate_event_stats,
                                        collect_candidates, filter_junctions,
                                        select_best)
from tophat_tpu.pipeline.segment import build_genome_space


def revcomp_rows(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """(B, L) left-aligned codes -> revcomp rows, still left-aligned."""
    B, L = codes.shape
    if B == 0:
        return codes.copy()
    lengths = np.asarray(lengths)
    # gather the mirrored columns per row: out[i, j] = comp(codes[i, l-1-j])
    src = lengths[:, None] - 1 - np.arange(L)[None, :]
    ok = src >= 0
    g = np.take_along_axis(codes, np.clip(src, 0, L - 1), axis=1)
    comp = np.where((g >= 0) & (g < 4), 3 - g, g)  # N/pad codes pass through
    return np.where(ok, comp, np.int8(-1)).astype(np.int8)


def load_reads(files: List[str], quals_scale: str,
               integer_quals: bool = False) -> ReadBatch:
    records = []
    for path in files:
        records.extend(read_all(path, quals_scale,
                                integer_quals=integer_quals))
    return batch_reads(records)


def iter_read_batches(files: List[str], quals_scale: str, batch_size: int,
                      integer_quals: bool = False):
    """Stream (name, seq, qual) records into fixed-size ReadBatches — the
    host input pipeline role of ZReader + prep_reads streaming (reference:
    src/tophat.py:1756, prep_reads.cpp:337)."""
    buf = []
    for path in files:
        for rec in read_all(path, quals_scale,
                            integer_quals=integer_quals):
            buf.append(rec)
            if len(buf) >= batch_size:
                yield batch_reads(buf)
                buf = []
    if buf:
        yield batch_reads(buf)


@dataclasses.dataclass
class MateState:
    """Per-mate intermediate state flowing between stages."""

    batch: ReadBatch
    keep: np.ndarray
    aln: Alignments
    gs: object
    prep_stats: object
    seg_tables: tuple = None
    stitched: tuple = None  # (pos, mm, ok) (rows, H) contiguous chains
    cands: Optional[Dict[int, list]] = None
    gapped: list = None     # bowtie2-mode direct gapped results
    gapped_events: Optional[dict] = None
    trans_hits: Optional[dict] = None  # _reads_vs_T rebased hits


def _align_mate(fm, offsets, batch: ReadBatch, params: Params, log,
                genome=None, trans=None):
    """Prep + transcriptome mapping + full-read genome alignment for one
    mate. Returns (MateState without spliced stages, ium mask,
    reads_f, reads_r, lengths) — the grouped driver aligns against several
    sub-indexes before deciding the global IUM set."""
    keep, prep_stats = prep_filter(batch)
    reads_f = batch.codes
    reads_r = revcomp_rows(batch.codes, batch.lengths)
    lengths = batch.lengths.astype(np.int32)

    # over-budget index + active mesh: range-shard the FM index over the
    # genome axis before the first device stage (parallel/auto.py)
    from tophat_tpu.parallel import auto

    if auto.active() is not None and genome is not None and batch.size:
        auto.configure_genome_axis(fm, genome, int(lengths.max()), log=log)

    # transcriptome mapping first (_reads_vs_T): reads placed on annotated
    # transcripts skip the genome/segment path entirely, like the reference
    # feeding only m2g_unmapped into _reads_vs_G (tophat.py:3326, 3538)
    trans_hits = None
    has_t = np.zeros(batch.size, bool)
    if trans is not None and genome is not None and trans.n:
        from tophat_tpu.pipeline.transcriptome import map_reads_transcriptome

        trans_hits = map_reads_transcriptome(trans, genome, reads_f,
                                             reads_r, lengths, params)
        # -x/--transcriptome-max-hits (reference usage tophat.py:97):
        # reads with more transcriptome placements are discarded — they
        # neither report nor continue to the genome stages
        tmax = getattr(params, "transcriptome_max_hits", 0)
        if tmax:
            over = [r for r, h in trans_hits.items() if len(h) > tmax]
            for r in over:
                del trans_hits[r]
                has_t[r] = True      # discarded, not IUM
            if over:
                log(f"transcriptome map: {len(over)} reads discarded "
                    f"(> {tmax} transcriptome hits)")
        for r in trans_hits:
            has_t[r] = True
        log(f"transcriptome map: {int(has_t.sum())} reads placed on "
            f"annotated transcripts")

    from tophat_tpu.ops.align import align_reads_adaptive, kmer_fast_ok

    if getattr(params, "transcriptome_only", False):
        # -T/--transcriptome-only (reference: tophat.py:96): report only
        # transcriptome placements; nothing maps to the genome and no
        # spliced discovery runs
        B = batch.size
        M = 1
        aln = Alignments(pos=np.zeros((B, M), np.int32),
                         strand=np.zeros((B, M), np.int8),
                         mm=np.zeros((B, M), np.int8),
                         valid=np.zeros((B, M), bool),
                         n_hits=np.zeros(B, np.int32),
                         truncated=np.zeros(B, bool))
        m = MateState(batch=batch, keep=keep, aln=aln, gs=None,
                      prep_stats=prep_stats, trans_hits=trans_hits)
        return m, np.zeros(B, bool), reads_f, reads_r, lengths

    min_len = int(lengths.min()) if len(lengths) else 0
    max_len = int(lengths.max()) if len(lengths) else 0
    aln = align_reads_adaptive(
        fm, reads_f, reads_r, lengths, offsets,
        max_mismatches=params.read_mismatches,
        max_alignments=params.max_alignments,
        kmer_fast=kmer_fast_ok(fm, min_len, params.read_mismatches),
        narrow_hits=min(8, params.hits_per_seed),
        wide_hits=params.hits_per_seed,
        uniform_len=min_len if min_len == max_len else 0)
    if not isinstance(aln.pos, np.ndarray):
        # device result: compact to the flat valid entries before the
        # host transfer (ops/align.transfer_alignments)
        from tophat_tpu.ops.align import transfer_alignments

        aln = transfer_alignments(aln)
    if params.prefilter_multihits:
        # -M/--prefilter-multihits (reference: tophat.py:3995-4026 +
        # prep_reads flt_reads): reads with more than max_multihits genomic
        # placements are dropped before any spliced stage
        keep = keep & ~(np.asarray(aln.n_hits) > params.max_multihits)
    valid = np.asarray(aln.valid) & keep[:, None]
    n_hits = np.where(keep, np.asarray(aln.n_hits), 0)
    aln = Alignments(pos=np.asarray(aln.pos), strand=np.asarray(aln.strand),
                     mm=np.asarray(aln.mm), valid=valid, n_hits=n_hits,
                     truncated=np.asarray(aln.truncated))
    ium = keep & (n_hits == 0) & ~has_t
    # --read-realign-edit-dist (reference usage tophat.py:62): mapped
    # reads whose best contiguous alignment has at least this edit
    # distance also enter the spliced stages, competing with any spliced
    # placement found there. Default (read_edit_dist + 1) realigns none.
    rre = getattr(params, "read_realign_edit_dist", -1)
    if rre < 0:
        rre = params.read_edit_dist + 1
    if rre <= params.read_edit_dist:
        mm_t = np.where(valid, np.asarray(aln.mm, np.int32), 127)
        best_mm = mm_t.min(axis=1, initial=127)
        ium |= keep & ~has_t & (n_hits > 0) & (best_mm >= rre)
    log(f"genome map: {int((n_hits > 0).sum())} mapped, {int(ium.sum())} IUM")
    m = MateState(batch=batch, keep=keep, aln=aln, gs=None,
                  prep_stats=prep_stats, trans_hits=trans_hits)
    return m, ium, reads_f, reads_r, lengths


def _spliced_mate(fm, offsets, m: MateState, params: Params, log,
                  ium, reads_f, reads_r, lengths) -> None:
    """Segment split + mapping + contiguous stitch (+ bowtie2-mode gapped)
    for the IUM reads; fills gs/seg_tables/stitched/gapped on `m`."""
    import jax.numpy as jnp

    from tophat_tpu.ops.stitch import stitch_contiguous
    from tophat_tpu.pipeline.segment import map_segments

    gs = build_genome_space(reads_f, reads_r, lengths,
                            params.segment_length, row_mask=ium,
                            pad_rows_pow2=True)
    m.gs = gs
    if gs.rows:
        m.seg_tables = map_segments(
            fm, offsets, gs, segment_mismatches=params.segment_mismatches,
            hits_per_seed=params.hits_per_seed, max_hits=16)
        st = stitch_contiguous(
            jnp.asarray(m.seg_tables[0]), jnp.asarray(m.seg_tables[1]),
            jnp.asarray(m.seg_tables[2]), jnp.asarray(gs.cuts),
            jnp.asarray(gs.nseg))
        m.stitched = tuple(np.asarray(x) for x in st)
    if params.bowtie2 and m.seg_tables is not None:
        # bowtie2-mode direct gapped alignment of the IUM reads (no
        # segment-pair discovery needed; reference tophat.py:2253-2337)
        from tophat_tpu.ops.gapped import gapped_from_segments

        m.gapped_events, m.gapped = gapped_from_segments(
            fm.genome, gs, m.seg_tables, params,
            offsets=offsets)
        if m.gapped:
            log(f"bowtie2 gapped: {len(m.gapped)} direct indel alignments")


def _map_mate(fm, offsets, batch: ReadBatch, params: Params, log,
              genome=None, trans=None) -> MateState:
    m, ium, reads_f, reads_r, lengths = _align_mate(
        fm, offsets, batch, params, log, genome=genome, trans=trans)
    _spliced_mate(fm, offsets, m, params, log, ium, reads_f, reads_r,
                  lengths)
    return m


def pipeline_core(genome: Genome, batches: List[ReadBatch], params: Params,
                  fm: Optional[FMIndex] = None,
                  known_events: Optional[Dict[str, np.ndarray]] = None,
                  gtf_accept=None, trans=None, log=print):
    """Run prep/map/discover/realign/filter for 1 (single) or 2 (paired)
    read batches. Returns (mates, events, stats, accepted, fm)."""
    if fm is None:
        from tophat_tpu.index.fm import default_kmer_k

        log("Building FM index...")
        fm = build_fm_index(genome, kmer_k=default_kmer_k(genome.n))
    offsets = genome.offsets.astype(np.int32)

    mates = [_map_mate(fm, offsets, b, params, log, genome=genome,
                       trans=trans) for b in batches]

    # joint discovery over every mate's IUM reads
    tables = [discover_events(fm, offsets, m.gs, params,
                              seg_tables=m.seg_tables, log=log,
                              read_side=mi)
              for mi, m in enumerate(mates)]
    if params.coverage_search:
        from tophat_tpu.pipeline.coverage import coverage_search_events

        for m in mates:
            if m.seg_tables is not None:
                cov_ev = coverage_search_events(fm, genome, m.gs,
                                                m.seg_tables, params)
                if len(cov_ev["left"]):
                    log(f"coverage search: {len(cov_ev['left'])} "
                        f"island-end pairing candidates")
                tables.append(cov_ev)
    if params.butterfly_search or params.microexon_search:
        from tophat_tpu.pipeline.butterfly import (butterfly_search_events,
                                                   microexon_events)

        for m in mates:
            if m.seg_tables is None:
                continue
            if params.butterfly_search:
                bev = butterfly_search_events(fm, genome, m.gs,
                                              m.seg_tables, params)
                if len(bev["left"]):
                    log(f"butterfly search: {len(bev['left'])} "
                        f"extendable candidates")
                tables.append(bev)
            if params.microexon_search:
                mev = microexon_events(fm, genome, m.gs, m.seg_tables,
                                       params)
                if len(mev["left"]):
                    log(f"microexon search: {len(mev['left'])} "
                        f"window candidates")
                tables.append(mev)
    for m in mates:
        if m.gapped_events is not None:
            tables.append(m.gapped_events)
    if known_events is not None:
        tables.append(known_events)
    events = merge_events(*tables)

    for m in mates:
        candidates_for_mate(fm, m, events, params, log,
                            paired=len(mates) > 1)

    # pass 1: stats + acceptance over all mates' candidates
    stats: Dict[int, object] = {}
    for m in mates:
        merge_stats(stats, accumulate_event_stats(
            m.cands, events, m.batch.lengths.astype(np.int32)))
    filter_junctions(events, stats, params, gtf_accept=gtf_accept)
    accepted = {e for e, st in stats.items() if st.accepted}
    return mates, events, stats, accepted, fm


def _v2_score_of(params, mates, events, stats):
    """--v2-sam selection key: the AlignStatus coverage-scaled alignment
    score (pipeline/align_status.py); None keeps the gold v1 ranking."""
    if not getattr(params, "v2_sam", False):
        return None
    from tophat_tpu.pipeline.align_status import v2_score_map

    smap = v2_score_map([m.cands for m in mates],
                        [m.batch.lengths for m in mates], events, stats)
    return lambda c: smap[id(c)]


def merge_stats(into: Dict[int, object], other: Dict[int, object]) -> None:
    for e, st in other.items():
        if e in into:
            prev = into[e]
            prev.supporting += st.supporting
            prev.left_extent = max(prev.left_extent, st.left_extent)
            prev.right_extent = max(prev.right_extent, st.right_extent)
            prev.min_mm = min(prev.min_mm, st.min_mm)
        else:
            into[e] = st


def candidates_for_mate(fm, m: MateState, events, params, log,
                        paired=False, chain_default=True) -> None:
    """Realign one chunk/mate against the (global) event table and build its
    candidate lists. chain_default=False defers the default-mode chain
    stitching to the caller (the grouped driver, which knows the global
    resolved-read set)."""
    max_nseg = int(m.gs.nseg.max()) if m.gs.rows else 1
    realign_mm = params.segment_mismatches * max_nseg
    if m.gs.rows and len(events["left"]):
        ev = dict(events)
        ev["valid"] = np.ones(len(ev["left"]), bool)
        spl = realign_events_sparse(fm.genome, m.gs.readsg, m.gs.lengths,
                                    ev, max_mm=realign_mm)
    else:
        z = np.zeros(0, np.int32)
        spl = (z, z.copy(), z.copy(), z.copy())
    fr_results = []
    fr_event_pairs = {"fr": (), "rf": ()}
    if params.fusion_search and m.gs.rows:
        from tophat_tpu.ops.fusion_fr import find_fr_fusions

        fr_results = find_fr_fusions(fm, m.gs, m.seg_tables, None, params)
        for res in fr_results:
            pairs = sorted({(int(a), int(b)) for a, b in
                            zip(res["posA"], res["posB"])}
                           | {(int(b), int(a)) for a, b in
                              zip(res["posA"], res["posB"])})
            fr_event_pairs[res["pattern"]] = tuple(pairs)[:64]
    chain_cands = None
    if params.fusion_search and m.gs.rows and len(events["left"]):
        from tophat_tpu.pipeline.chains import (chain_stitch,
                                                cross_strand_chains)

        chain_cands = chain_stitch(fm, m.gs, m.seg_tables, events, params)
        chain_cands += cross_strand_chains(fm, m.gs, m.seg_tables, events,
                                           params, fr_events=fr_event_pairs)
        if chain_cands:
            log(f"chain stitch: {len(chain_cands)} multi-event chains")
    m.cands = collect_candidates(m.aln, m.gs, events, *spl, params,
                                 stitched=m.stitched,
                                 genome_codes=host_codes(fm),
                                 chain_cands=chain_cands, paired=paired)

    # transcriptome-mapped reads report ONLY their rebased transcript hits
    # (the reference never genome-maps them: only m2g_unmapped feeds
    # _reads_vs_G, tophat.py:3326)
    if m.trans_hits:
        from tophat_tpu.pipeline.transcriptome import \
            transcriptome_candidates

        for r, lst in transcriptome_candidates(m.trans_hits, events,
                                               params).items():
            m.cands[r] = lst

    # bowtie2-mode direct gapped candidates (bypass the v1.1.4 segment-path
    # indel admission — these come straight from the initial aligner)
    if m.gapped:
        from tophat_tpu.pipeline.report import Candidate

        ev_index = {}
        for i in range(len(events["left"])):
            ev_index[(int(events["kind"][i]), int(events["left"][i]),
                      int(events["right"][i]))] = i
        nb2 = 0
        for row, pos, t, gap, mm2, key in m.gapped:
            read = int(m.gs.read_idx[row])
            if read < 0:
                continue
            ev = ev_index.get(key, -1)
            if ev < 0:
                continue
            c = Candidate(read=read, pos=pos, strand=int(m.gs.strand[row]),
                          mm=mm2, kind=int(events["kind"][ev]), ev=ev, t=t,
                          gap=abs(gap), record_ok=True)
            lst = m.cands.setdefault(read, [])
            if not any(x.kind == c.kind and x.ev == ev and x.t == t
                       and x.pos == pos for x in lst):
                lst.append(c)
                nb2 += 1
        if nb2:
            log(f"bowtie2 direct candidates: {nb2}")

    # cross-strand (FR/RF) fusion candidates
    if params.fusion_search and m.gs.rows:
        from tophat_tpu.ops.splice import KIND_FUSION
        from tophat_tpu.pipeline.report import Candidate

        nfr = 0
        for res in fr_results:
            for rr, t, pa, pb, mm2 in zip(res["read"], res["t"],
                                          res["posA"], res["posB"],
                                          res["mm"]):
                read = int(m.gs.read_idx[int(rr)])
                if read < 0:  # pow2 padding row
                    continue
                rl = int(m.gs.lengths[int(rr)])
                t = int(t)
                if t < 3 or rl - t < 3:  # record-geometry floor; the 20bp
                    continue             # rule gates counting, not reporting
                if res["pattern"] == "fr":
                    pos = int(pa) - t + 1
                else:
                    pos = int(pa)
                c = Candidate(read=read, pos=pos, strand=0, mm=int(mm2),
                              kind=KIND_FUSION, ev=-1, t=t,
                              fdir=res["pattern"], fpos2=int(pb))
                lst = m.cands.setdefault(read, [])
                if not any(x.kind == KIND_FUSION and x.pos == c.pos
                           and x.t == c.t and x.fdir == c.fdir
                           for x in lst):
                    lst.append(c)
                    nfr += 1
        if nfr:
            log(f"cross-strand fusion candidates: {nfr}")

    # default-mode multi-event chains for still-unresolved reads
    if chain_default and not params.fusion_search:
        default_chains(fm, m, events, params, log)


def default_chains(fm, m: MateState, events, params, log,
                   resolved=None) -> None:
    """Multi-event chains for the default (non-fusion) mode: a read crossing
    >= 2 events (two introns, intron + indel, ...) has no contiguous or
    single-event placement, so it is still unresolved after
    collect_candidates. Stitch chains for exactly those reads' genome-space
    rows (the reference's dfs_seg_hits / merge_chain join runs for every
    read by default, long_spanning_reads.cpp:2222, :805 — resolved reads
    would only get chains that lose selection, so restricting to unresolved
    rows changes nothing in the output while keeping the stage off the hot
    path). `resolved` overrides the resolved-read set (the grouped driver
    passes the global one)."""
    if not (m.gs is not None and m.gs.rows and len(events["left"])
            and m.seg_tables is not None):
        return
    from tophat_tpu.pipeline.chains import chain_stitch, subset_rows
    from tophat_tpu.pipeline.report import Candidate

    if resolved is None:
        resolved = [r for r, cl in m.cands.items() if cl]
    unresolved = ~np.isin(m.gs.read_idx, list(resolved))
    rows_sel = np.nonzero(unresolved & (m.gs.read_idx >= 0)
                          & (m.gs.nseg >= 2))[0]
    if not len(rows_sel):
        return
    sub_gs, sub_tables = subset_rows(m.gs, m.seg_tables, rows_sel)
    nchain = 0
    for cc in chain_stitch(fm, sub_gs, sub_tables, events, params):
        m.cands.setdefault(cc.read, []).append(Candidate(
            read=cc.read, pos=cc.pos, strand=cc.strand, mm=cc.mm,
            kind=-2, ev=-1, t=0, chain_ops=tuple(cc.ops),
            chain_events=tuple(cc.events)))
        nchain += 1
    if nchain:
        log(f"default chain stitch: {nchain} multi-event chains "
            f"over {len(rows_sel)} unresolved rows")


def run_pipeline(genome: Genome, batch: ReadBatch, params: Params,
                 out_dir: str, fm: Optional[FMIndex] = None,
                 known_events: Optional[Dict[str, np.ndarray]] = None,
                 gtf_accept=None, trans=None, log=print):
    from tophat_tpu.pipeline.report import write_outputs

    t0 = time.time()
    os.makedirs(out_dir, exist_ok=True)
    mates, events, stats, accepted, fm = pipeline_core(
        genome, [batch], params, fm=fm, known_events=known_events,
        gtf_accept=gtf_accept, trans=trans, log=log)
    m = mates[0]
    with open(os.path.join(out_dir, "prep_reads.info"), "w") as f:
        f.write(m.prep_stats.info_text())

    rng = np.random.default_rng(1)
    score_of = _v2_score_of(params, [m], events, stats)
    selected = {}
    for r, clist in m.cands.items():
        usable = [c for c in clist
                  if (all(e in accepted for e in c.chain_events)
                      if c.kind == -2 else (c.ev < 0 or c.ev in accepted))]
        selected[r] = select_best(usable, params.max_multihits, rng,
                                  params.report_secondary,
                                  score_of=score_of)

    records = write_outputs(out_dir, genome, params, batch, selected, events)
    log(f"done in {time.time() - t0:.1f}s; {len(records)} alignments "
        f"reported")
    return dict(mates=mates, events=events, stats=stats, selected=selected,
                fm=fm)


def run_pipeline_streaming(genome: Genome, batch_iter, params: Params,
                           out_dir: str, fm: Optional[FMIndex] = None,
                           known_events=None, gtf_accept=None, trans=None,
                           tmp_dir=None, resume=False, log=print):
    """Chunked single-end pipeline for read sets larger than one device
    batch: per-chunk map + discovery, a global event union, per-chunk
    realignment, global junction filtering, and k-way-merged output
    (the chunk axis plays the role of the reference's per-thread read-ID
    ranges with a final merge, SURVEY.md §2.5)."""
    from tophat_tpu.pipeline.report import write_outputs_multi

    t0 = time.time()
    os.makedirs(out_dir, exist_ok=True)
    offsets = genome.offsets.astype(np.int32)

    # lazy index: a fully-resumed run (every chunk's mapped tables cached)
    # never touches the FM index — realignment and reporting only gather
    # from the genome codes
    fm_holder = [fm]

    def fm_get():
        if fm_holder[0] is None:
            from tophat_tpu.index.fm import default_kmer_k

            log("Building FM index...")
            fm_holder[0] = build_fm_index(genome,
                                          kmer_k=default_kmer_k(genome.n))
        return fm_holder[0]

    from tophat_tpu.pipeline.prep import PrepStats

    chunks: List[MateState] = []
    tables = []
    prep_all = PrepStats()
    for bi, batch in enumerate(batch_iter):
        m, chunk_tables = _mapped_chunk(fm_get, offsets, batch, params, log,
                                        genome=genome, trans=trans,
                                        tmp_dir=tmp_dir, resume=resume,
                                        tag=f"chunk{bi:05d}")
        tables.extend(chunk_tables)
        prep_all.merge(m.prep_stats)
        chunks.append(m)
        log(f"chunk {bi}: {batch.size} reads")
    if fm_holder[0] is None:
        import types

        fm = types.SimpleNamespace(genome=genome.codes)
    else:
        fm = fm_holder[0]
    if known_events is not None:
        tables.append(known_events)
    events = merge_events(*tables)
    log(f"{len(events['left'])} candidate events across "
        f"{len(chunks)} chunks")

    with open(os.path.join(out_dir, "prep_reads.info"), "w") as f:
        f.write(prep_all.info_text())

    stats: Dict[int, object] = {}
    for m in chunks:
        candidates_for_mate(fm, m, events, params, log)
        merge_stats(stats, accumulate_event_stats(
            m.cands, events, m.batch.lengths.astype(np.int32)))
    filter_junctions(events, stats, params, gtf_accept=gtf_accept)
    accepted = {e for e, st in stats.items() if st.accepted}

    rng = np.random.default_rng(1)
    score_of = _v2_score_of(params, chunks, events, stats)
    parts = []
    for m in chunks:
        selected = {}
        for r, clist in m.cands.items():
            usable = [c for c in clist
                      if (all(e in accepted for e in c.chain_events)
                          if c.kind == -2
                          else (c.ev < 0 or c.ev in accepted))]
            selected[r] = select_best(usable, params.max_multihits, rng,
                                      params.report_secondary,
                                      score_of=score_of)
        parts.append((m.batch, selected))

    records = write_outputs_multi(out_dir, genome, params, parts, events)
    log(f"streaming done in {time.time() - t0:.1f}s; {len(records)} "
        f"alignments over {len(chunks)} chunks")
    return dict(events=events, stats=stats, parts=parts, fm=fm)


def _mapped_chunk(fm_get, offsets, batch, params, log, genome=None,
                  trans=None, tmp_dir=None, resume=False, tag="chunk"):
    """Map + discover one chunk, with optional per-stage artifact reuse:
    when `tmp_dir` is set the mapped state + discovery tables persist as
    <tmp_dir>/<tag>.pkl, and `resume=True` reloads them instead of
    redoing the mapping (the reference's per-stage resume-skip,
    src/tophat.py:240 doResume + :2164-2176 bowtie resume_skip).
    fm_get: zero-arg callable returning the FM index (built lazily — a
    resumed chunk never needs it)."""
    import pickle

    art = os.path.join(tmp_dir, f"{tag}.pkl") if tmp_dir else None
    key = _chunk_key(batch, params) if art else None
    if resume and art and os.path.exists(art):
        try:
            with open(art, "rb") as f:
                m, chunk_tables, stored_key = pickle.load(f)
            if stored_key == key:
                m.batch = batch     # reads reload from the input files
                log(f"[resume] {tag}: reusing mapped tables")
                return m, chunk_tables
            log(f"[resume] {tag}: input/params changed, remapping")
        except Exception:
            pass  # corrupt/stale artifact: redo the stage
    fm = fm_get() if callable(fm_get) else fm_get
    m = _map_mate(fm, offsets, batch, params, log, genome=genome,
                  trans=trans)
    chunk_tables = [discover_events(fm, offsets, m.gs, params,
                                    seg_tables=m.seg_tables, log=None)]
    if params.coverage_search and m.seg_tables is not None:
        from tophat_tpu.pipeline.coverage import coverage_search_events

        chunk_tables.append(coverage_search_events(fm, genome, m.gs,
                                                   m.seg_tables, params))
    if ((params.butterfly_search or params.microexon_search)
            and m.seg_tables is not None):
        from tophat_tpu.pipeline.butterfly import (butterfly_search_events,
                                                   microexon_events)

        if params.butterfly_search:
            chunk_tables.append(butterfly_search_events(
                fm, genome, m.gs, m.seg_tables, params))
        if params.microexon_search:
            chunk_tables.append(microexon_events(fm, genome, m.gs,
                                                 m.seg_tables, params))
    if m.gapped_events is not None:
        chunk_tables.append(m.gapped_events)
    if art:
        batch_ref = m.batch
        try:
            os.makedirs(tmp_dir, exist_ok=True)
            if m.seg_tables is not None:   # device arrays don't pickle
                m.seg_tables = tuple(np.asarray(a) for a in m.seg_tables)
            m.batch = None          # reads live in the input files
            with open(art, "wb") as f:
                pickle.dump((m, chunk_tables, key), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
        except OSError:
            pass                    # artifact write is best-effort
        finally:
            m.batch = batch_ref
    return m, chunk_tables


def _chunk_key(batch, params) -> str:
    """Content identity of a chunk's mapped-artifact: a digest of the reads
    themselves (names + codes + lengths) and of every mapping-relevant
    parameter. Swapping the input file for a different one with the same
    read count, or changing alignment params, invalidates the artifact —
    the role of the reference's original-argv replay + validation on -R
    (src/tophat.py:240-266), keyed by content instead of path+mtime so
    copied/moved inputs still resume."""
    import dataclasses
    import hashlib

    h = hashlib.sha1()
    h.update(repr(sorted(dataclasses.asdict(params).items())).encode())
    h.update(np.ascontiguousarray(batch.codes).tobytes())
    h.update(np.ascontiguousarray(batch.lengths).tobytes())
    for n in batch.names:
        h.update(n.encode() if isinstance(n, str) else bytes(n))
        h.update(b"\0")
    return h.hexdigest()
