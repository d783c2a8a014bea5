"""Device mesh and sharding layout.

The reference's only parallelism is read-range sharding across
boost::threads with a single-threaded merge (reference:
src/utils.cpp:22 calculate_offsets; worker fan-outs at
segment_juncs.cpp:4763, long_spanning_reads.cpp:3052,
tophat_reports.cpp:2742). The device-mesh layout generalizes it:

  axis "reads"  — data parallelism over the read batch (the analog of the
                  reference's per-thread read-ID ranges)
  axis "genome" — optional range sharding of verification gathers /
                  window scans over the genome (for indexes larger than
                  one chip's HBM, and for scaling coverage-style scans)

The FM index is replicated across "reads" and may be sharded over
"genome"; per-shard junction/hit statistics merge with psum/all_gather —
the collective analog of the reference's single-threaded merge_with.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

READS_AXIS = "reads"
GENOME_AXIS = "genome"


def make_mesh(n_reads_shards: int | None = None, n_genome_shards: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_reads_shards is None:
        n_reads_shards = n // n_genome_shards
    assert n_reads_shards * n_genome_shards == n, (
        f"{n_reads_shards}x{n_genome_shards} != {n} devices")
    dev = np.asarray(devices).reshape(n_reads_shards, n_genome_shards)
    return Mesh(dev, (READS_AXIS, GENOME_AXIS))


def reads_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-axis sharding for read arrays (B, ...)."""
    return NamedSharding(mesh, P(READS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
