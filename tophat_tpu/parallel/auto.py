"""Automatic multi-device execution of the production pipeline.

The reference parallelizes every heavy per-read loop by read-range sharding
across boost::threads with private result sets merged single-threaded
(reference: src/utils.cpp:22 calculate_offsets; worker fan-outs at
segment_juncs.cpp:4763, long_spanning_reads.cpp:3052,
tophat_reports.cpp:2742-2815). The device-mesh equivalent implemented here:
when a mesh is active, every device-side stage of the real pipeline —
full-read alignment, segment mapping, junction/indel/fusion window scans,
and event realignment — runs as one SPMD program with its row axis sharded
over the mesh's "reads" axis (jax.sharding.NamedSharding + jit/GSPMD), the
FM index and genome replicated, and results gathered to host for the same
order-preserving merge the single-device path uses. Because each sharded
stage is row-independent and rows are padded by edge-replication then
sliced back, outputs are bit-identical to the single-device run — the
multi-chip analog of the reference's deterministic thread merge.

Activation: pipeline entry points call `auto_activate()` which builds a 1-D
("reads") mesh over all visible devices (overridable with
TOPHAT_TPU_DEVICES=<n>; n=1 disables). Tests drive both paths explicitly.
"""

from __future__ import annotations

import os
from typing import Any, List, Tuple

import numpy as np

_MESH = None
_REPL: List[Tuple[Any, Any]] = []  # [(host_obj, replicated_obj)] strong refs
_GSHARD = None  # range-sharded FM state (see configure_genome_axis)

# Share of a device's memory limit that a replicated FM index may take;
# beyond it the genome axis activates and the index range-shards. The
# other half is headroom for read batches, hit and event tables (the
# mesh realign path materializes (R, E, L) volumes of several GiB) and
# XLA scratch.
INDEX_MEMORY_SHARE = 0.5


def active():
    return _MESH


def activate(mesh) -> None:
    global _MESH
    _MESH = mesh
    _REPL.clear()


def deactivate() -> None:
    global _MESH, _GSHARD
    _MESH = None
    _GSHARD = None
    _REPL.clear()


def auto_activate(log=None) -> None:
    """Build a reads-axis mesh over all visible devices (if more than one).

    TOPHAT_TPU_DEVICES=<n> caps the device count; 1 disables sharding.
    """
    import jax

    from tophat_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    cap = os.environ.get("TOPHAT_TPU_DEVICES")
    if cap is not None:
        n = min(n, max(1, int(cap)))
    if n <= 1:
        deactivate()
        return
    activate(make_mesh(n_reads_shards=n, n_genome_shards=1,
                       devices=jax.devices()[:n]))
    if log:
        log(f"multi-device: sharding read batches over {n} devices")


def n_row_shards() -> int:
    if _MESH is None:
        return 1
    from tophat_tpu.parallel.mesh import READS_AXIS

    return _MESH.shape[READS_AXIS]


def index_budget(device) -> int | None:
    """Bytes of one device that a replicated FM index may take:
    $TOPHAT_TPU_HBM_BYTES when set, else INDEX_MEMORY_SHARE of the limit
    the device reports (memory_stats()["bytes_limit"]). None when the
    device reports no limit (the CPU): no size is assumed then."""
    env = os.environ.get("TOPHAT_TPU_HBM_BYTES")
    if env:
        return int(env)
    stats = device.memory_stats()
    if not stats or not stats.get("bytes_limit"):
        return None
    return int(stats["bytes_limit"] * INDEX_MEMORY_SHARE)


def genome_sharded(fm=None) -> bool:
    """True when the FM index is range-sharded over the mesh's genome axis
    (the production path routes FM-search stages through shard_fm then).

    fm: when given, additionally require that it is the index the shards
    were built from — auxiliary indexes (colorspace, fusion-post locals)
    must fall through to the replicated path, not silently search the
    base-genome shards."""
    if _GSHARD is None:
        return False
    return fm is None or _GSHARD["src"] is fm


def configure_genome_axis(fm, genome, max_read_len: int, log=None) -> None:
    """Range-shard the FM index over a genome mesh axis when replicating it
    would blow the per-device HBM budget (SURVEY §2.5 index-sharding row;
    the reference has no analog — bowtie replicates its whole-genome index
    into every process, src/tophat.py:2286).

    Idempotent per (fm, mesh). Budget: index_budget of the mesh's first
    device; $TOPHAT_TPU_GENOME_SHARDS forces a shard count. The mesh
    factors n_devices into (reads=n/g, genome=g) with g the smallest
    divisor of n that brings every sub-index under budget. With no budget
    known (the CPU) the genome axis activates only when forced.
    Sub-indexes rebuild from the genome codes (at production scale they
    would persist beside the <prefix>.tt.npz cache; rebuild cost ~= one
    index build)."""
    global _GSHARD
    if _MESH is None or fm is None or genome is None:
        return
    if _GSHARD is not None and _GSHARD["src"] is fm:
        if max_read_len <= _GSHARD["overlap"] + 1:
            return
    n_dev = int(np.prod(list(_MESH.shape.values())))
    forced = os.environ.get("TOPHAT_TPU_GENOME_SHARDS")
    devices = list(np.asarray(_MESH.devices).reshape(-1))
    nbytes = fm.nbytes
    budget = None if forced is not None else index_budget(devices[0])
    if forced is not None:
        g = max(1, int(forced))
    elif budget is None:
        return
    else:
        g = next((d for d in range(1, n_dev + 1)
                  if n_dev % d == 0 and nbytes / d <= budget), n_dev)
    if g <= 1 or n_dev % g or n_dev // g < 1:
        return
    from tophat_tpu.parallel.mesh import make_mesh
    from tophat_tpu.parallel.shard_fm import build_sharded_fm

    overlap = max(2 * int(max_read_len), 256)
    stacked, starts = build_sharded_fm(
        genome, g, overlap, kmer_k=fm.kmer_k, sa_rate=fm.sa_rate)
    n_bases = int(np.asarray(genome.codes).shape[0])
    owned_width = (n_bases + g - 1) // g
    activate(make_mesh(n_reads_shards=n_dev // g, n_genome_shards=g,
                       devices=devices))
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tophat_tpu.parallel.mesh import GENOME_AXIS

    spec = NamedSharding(_MESH, P(GENOME_AXIS))
    import jax

    stacked_d = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, spec), stacked)
    _GSHARD = dict(src=fm, fm=stacked_d,
                   starts=jax.device_put(starts.astype(np.int32), spec),
                   owned_width=owned_width, overlap=overlap, g=g, fns={})
    if log:
        log(f"index range-sharded over {g} devices "
            f"({nbytes / (1 << 30):.2f} GiB total, "
            f"{nbytes / g / (1 << 30):.2f} GiB/device; reads axis "
            f"{n_dev // g})")


def _gshard_fn(kind: str, **kw):
    key = (kind, tuple(sorted(
        (k, tuple(sorted(v.items())) if isinstance(v, dict) else v)
        for k, v in kw.items())))
    fn = _GSHARD["fns"].get(key)
    if fn is None:
        from tophat_tpu.parallel import shard_fm

        make = {"full": shard_fm.make_sharded_align,
                "rows": shard_fm.make_sharded_align_rows,
                "beam": shard_fm.make_sharded_beam_rows}[kind]
        fn = make(_MESH, owned_width=_GSHARD["owned_width"], **kw)
        _GSHARD["fns"][key] = fn
        if len(_GSHARD["fns"]) > 32:
            _GSHARD["fns"].pop(next(iter(_GSHARD["fns"])))
    return fn


def sharded_align(reads_f, reads_r, lengths, offsets, *, max_mismatches,
                  hits_per_seed, max_alignments, kmer_fast, resolve_cap,
                  uniform_len):
    """Full-read alignment against the range-sharded index (both strands).
    Returns an ops.align.Alignments. Only call when genome_sharded()."""
    from tophat_tpu.ops.align import Alignments

    fn = _gshard_fn("full", max_mismatches=max_mismatches,
                    hits_per_seed=hits_per_seed,
                    max_alignments=max_alignments, kmer_fast=kmer_fast,
                    resolve_cap=resolve_cap, uniform_len=uniform_len)
    (rf, rr, ln), B = shard_rows(reads_f, reads_r, lengths)
    pos, st, mm, va, nh, tr = fn(_GSHARD["fm"], _GSHARD["starts"],
                                 replicated(np.asarray(offsets)), rf, rr, ln)
    return Alignments(pos=np.asarray(pos)[:B], strand=np.asarray(st)[:B],
                      mm=np.asarray(mm)[:B], valid=np.asarray(va)[:B],
                      n_hits=np.asarray(nh)[:B],
                      truncated=np.asarray(tr)[:B])


def sharded_align_rows(reads, lengths, offsets, *, max_mismatches,
                       hits_per_seed, max_hits):
    """Forward-rows (segment) alignment against the range-sharded index.
    Returns (pos, mm, valid, n_hits, truncated) numpy arrays."""
    fn = _gshard_fn("rows", max_mismatches=max_mismatches,
                    hits_per_seed=hits_per_seed, max_hits=max_hits)
    (rd, ln), B = shard_rows(reads, lengths)
    out = fn(_GSHARD["fm"], _GSHARD["starts"],
             replicated(np.asarray(offsets)), rd, ln)
    return tuple(np.asarray(a)[:B] for a in out)


def sharded_beam_rows(reads, lengths, offsets, *, max_hits, plan):
    """Half-split + variant (full-sensitivity) segment search against the
    range-sharded index (ops/beam.py semantics). Returns numpy arrays."""
    fn = _gshard_fn("beam", max_hits=max_hits, plan=plan)
    (rd, ln), B = shard_rows(reads, lengths)
    out = fn(_GSHARD["fm"], _GSHARD["starts"],
             replicated(np.asarray(offsets)), rd, ln)
    return tuple(np.asarray(a)[:B] for a in out)


def replicated(obj):
    """device_put a pytree fully replicated over the mesh (identity-cached:
    the FM index / genome are placed once per pipeline)."""
    if _MESH is None:
        return obj
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    for host, dev in _REPL:
        if host is obj:
            return dev
    dev = jax.device_put(obj, NamedSharding(_MESH, P()))
    _REPL.append((obj, dev))
    if len(_REPL) > 16:  # bound device memory pinned by the cache
        _REPL.pop(0)
    return dev


def release(obj) -> None:
    """Evict `obj` from the replication cache, dropping the strong device
    ref so HBM frees once callers' copies die (throwaway indexes — e.g.
    the colorspace transition index — must not stay pinned through the
    subsequent base-space pipeline)."""
    _REPL[:] = [(h, d) for h, d in _REPL if h is not obj]


def shard_rows(*arrays):
    """Pad each array's leading dim (all equal) up to a multiple of the
    reads-axis size by edge replication, then device_put sharded over dim 0.

    Returns (device_arrays, n_orig_rows). Callers slice outputs back to
    n_orig_rows; edge-replicated pad rows compute duplicate results that are
    discarded, keeping sharded results bit-identical to unsharded ones.
    With no active mesh, returns the arrays untouched.
    """
    B = int(np.asarray(arrays[0]).shape[0])
    if _MESH is None or B == 0:
        return list(arrays), B
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tophat_tpu.parallel.mesh import READS_AXIS

    n = _MESH.shape[READS_AXIS]
    pad = (-B) % n
    out = []
    spec = NamedSharding(_MESH, P(READS_AXIS))
    for a in arrays:
        a = np.asarray(a)
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        out.append(jax.device_put(a, spec))
    return out, B


def shard_pytree_rows(tree):
    """shard_rows for a pytree whose every leaf has the same leading dim.
    Returns (sharded_tree, n_orig_rows)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    sharded, B = shard_rows(*leaves)
    return jax.tree_util.tree_unflatten(treedef, sharded), B
