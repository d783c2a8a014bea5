"""Sharded pipeline step: the full align→segment→discover→realign flow as
one pjit/shard_map program over a ("reads", "genome") mesh.

Parallel layout (the device-mesh generalization of the reference's thread model,
see parallel/mesh.py):
  - read batch arrays are sharded over the "reads" axis (DP); the FM index
    is replicated, exactly like each boost::thread seeing the whole genome
    (reference: segment_juncs.cpp:4763 SegmentSearchWorker fan-out)
  - candidate events discovered per read-shard are exchanged with
    all_gather over "reads" — the collective analog of the reference's
    single-threaded JunctionSet merge (tophat_reports.cpp:2790 merge_with)
  - the merged event table is range-sharded over the "genome" axis for
    realignment (each genome shard owns E/ng events — an EP/TP-style model
    split), results re-joined with all_gather over "genome"

The step is fully static-shape and jittable; pipeline/run.py uses it when
more than one device is visible.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from tophat_tpu.ops.align import _align_one_strand
from tophat_tpu.ops.events import realign_chunk
from tophat_tpu.ops.splice import build_pair_windows, compact_windows, scan_windows
from tophat_tpu.ops.verify import same_contig
from tophat_tpu.parallel.mesh import GENOME_AXIS, READS_AXIS

def shard_map(f, mesh, in_specs, out_specs):
    """jax.shard_map with replication checking off: the step's cross-axis
    invariants are by construction, see module doc."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_sharded_pipeline_step(mesh, *, read_len: int, segment_length: int,
                               max_mismatches: int = 2,
                               hits_per_seed: int = 16,
                               max_alignments: int = 16,
                               max_windows: int = 1024,
                               max_events: int = 256,
                               min_seg_intron: int = 50,
                               max_seg_intron: int = 500000):
    """Build the jitted multi-chip step.

    Returned fn(fm, offsets, reads_f, reads_r, lengths) ->
      (aln_pos, aln_valid, aln_mm, n_hits, spl_mm, spl_t, spl_ok, n_events)
    with read-axis outputs sharded like the inputs.
    """
    from tophat_tpu.pipeline.prep import segment_offsets

    cuts_host = segment_offsets(read_len, segment_length)
    S = len(cuts_host) - 1
    max_seg_len = max(b - a for a, b in zip(cuts_host, cuts_host[1:]))
    nr = mesh.shape[READS_AXIS]
    ng = mesh.shape[GENOME_AXIS]
    ev_per_shard = max_events // ng
    assert ev_per_shard * ng == max_events

    def local_step(fm, offsets, reads_f, reads_r, lengths):
        B, L = reads_f.shape

        # ---- full-read alignment, both strands (DP over reads) ----
        pf, mf, vf, _ = _align_one_strand(fm, reads_f, lengths,
                                          max_mismatches, hits_per_seed)
        pr, mr, vr, _ = _align_one_strand(fm, reads_r, lengths,
                                          max_mismatches, hits_per_seed)
        pos = jnp.concatenate([pf, pr], axis=1)
        mm = jnp.concatenate([mf, mr], axis=1)
        valid = jnp.concatenate([vf, vr], axis=1)
        valid &= same_contig(offsets, pos, lengths[:, None])
        n_hits = valid.sum(axis=1).astype(jnp.int32)
        ium = n_hits == 0

        # ---- segment mapping in genome space (fixed cuts) ----
        cuts_f = jnp.asarray(cuts_host, jnp.int32)
        cuts_r = read_len - cuts_f[::-1]
        rowsg = jnp.concatenate([reads_f, reads_r], axis=0)
        cuts2 = jnp.concatenate([jnp.tile(cuts_f, (B, 1)),
                                 jnp.tile(cuts_r, (B, 1))], axis=0)
        seg_len_tbl = cuts2[:, 1:] - cuts2[:, :-1]
        SEGL = max_seg_len
        t = jnp.arange(SEGL, dtype=jnp.int32)
        src = cuts2[:, :-1][:, :, None] + t[None, None, :]
        ok = t[None, None, :] < seg_len_tbl[:, :, None]
        segs = jnp.where(
            ok, rowsg[jnp.arange(2 * B)[:, None, None],
                      jnp.clip(src, 0, L - 1)], jnp.int8(-1))
        sp, sm, sv, _ = _align_one_strand(
            fm, segs.reshape(2 * B * S, SEGL),
            jnp.maximum(seg_len_tbl.reshape(-1), 1), max_mismatches,
            hits_per_seed)
        H = 8
        order = jnp.argsort(~sv, axis=1, stable=True)[:, :H]
        take = lambda a: jnp.take_along_axis(a, order, axis=1)
        seg_pos = take(sp).reshape(2 * B, S, H)
        seg_mm = take(sm).reshape(2 * B, S, H)
        seg_valid = take(sv).reshape(2 * B, S, H)
        ium2 = jnp.concatenate([ium, ium])
        seg_valid &= ium2[:, None, None]

        # ---- junction discovery windows ----
        nseg2 = jnp.full((2 * B,), S, jnp.int32)
        len2 = jnp.concatenate([lengths, lengths])
        win = build_pair_windows(seg_pos, seg_valid, cuts2, nseg2, len2,
                                 min_seg_intron, max_seg_intron,
                                 segment_length)
        win, _ = compact_windows(win, max_windows)
        jl, jr, jrev, jvalid = scan_windows(fm.genome, rowsg, win,
                                            max_seg_len + 17)

        # compact local candidates to fixed slots
        flat_l = jl.reshape(-1)
        flat_r = jr.reshape(-1)
        flat_v = jvalid.reshape(-1)
        order = jnp.argsort(~flat_v, stable=True)[:ev_per_shard * ng]
        cl = jnp.take(flat_l, order)
        cr = jnp.take(flat_r, order)
        cv = jnp.take(flat_v, order)

        # ---- merge candidates across read shards (collective) ----
        gl = jax.lax.all_gather(cl, READS_AXIS).reshape(-1)[:max_events * 4]
        gr = jax.lax.all_gather(cr, READS_AXIS).reshape(-1)[:max_events * 4]
        gv = jax.lax.all_gather(cv, READS_AXIS).reshape(-1)[:max_events * 4]
        order2 = jnp.argsort(~gv, stable=True)[:max_events]
        ev_left = jnp.take(gl, order2)
        ev_right = jnp.take(gr, order2)
        ev_valid = jnp.take(gv, order2)
        n_events = jax.lax.psum(cv.sum(), READS_AXIS)

        # ---- event realignment, events range-sharded over "genome" ----
        gidx = jax.lax.axis_index(GENOME_AXIS)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(
            a, gidx * ev_per_shard, ev_per_shard)
        E = ev_per_shard
        bt, bmm, bok = realign_chunk(
            fm.genome, rowsg, len2, sl(ev_left), sl(ev_right),
            jnp.zeros(E, jnp.int8), jnp.zeros(E, jnp.int8),
            jnp.full((E, 8), -1, jnp.int8), sl(ev_valid),
            max_mm=max_mismatches)
        bt = jax.lax.all_gather(bt, GENOME_AXIS, axis=1).reshape(2 * B, -1)
        bmm = jax.lax.all_gather(bmm, GENOME_AXIS, axis=1).reshape(2 * B, -1)
        bok = jax.lax.all_gather(bok, GENOME_AXIS, axis=1).reshape(2 * B, -1)

        sl_a = slice(0, max_alignments)
        return (pos[:, sl_a], valid[:, sl_a], mm[:, sl_a], n_hits,
                bmm, bt, bok, n_events)

    pspec_reads = P(READS_AXIS)
    repl = P()
    fn = shard_map(
        local_step, mesh,
        in_specs=(repl, repl, pspec_reads, pspec_reads, pspec_reads),
        out_specs=(pspec_reads, pspec_reads, pspec_reads, pspec_reads,
                   pspec_reads, pspec_reads, pspec_reads, repl))
    return jax.jit(fn)
