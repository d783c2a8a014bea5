"""tophat_tpu — a JAX spliced-read (RNA-Seq) alignment framework for the GPU.

A from-scratch JAX/XLA re-design of the capabilities of TopHat2
(reference: DaehwanKimLab/tophat @ /root/reference): FM-index short-read
alignment, segment-based splice-junction discovery, indel/fusion detection,
spliced-alignment stitching and reporting — expressed as batched, jittable
array programs sharded over device meshes instead of a multi-process
CPU pipeline.

Layer map (a re-design, not a port):
  index/     genome packing + FM-index (BWT, checkpointed Occ, SA) build on host
  ops/       device compute: rank/backward-search, pigeonhole align, splice ops
  pipeline/  the TopHat stages as pure JAX programs over read batches
  io/        host-side FASTQ/FASTA/SAM/BAM/BED/GTF
  parallel/  jax.sharding mesh, shard_map pipeline, collective merges
  cli/       tophat-compatible command line
"""

__version__ = "0.1.0"

from tophat_tpu.index.fasta import Genome, read_fasta  # noqa: F401
from tophat_tpu.index.fm import FMIndex, build_fm_index  # noqa: F401
