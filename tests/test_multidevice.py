"""Multi-device execution of the PRODUCTION pipeline must be bit-identical
to single-device execution (the analog of the reference's requirement
that -p N threads not change output; thread fan-out + deterministic merge,
reference: src/tophat_reports.cpp:2742-2815, src/utils.cpp:22).

Runs real regression cases through the CLI twice — once on 1 device, once
sharded over the 8-device virtual mesh — and compares every output file.
"""

import os
import shlex

import pytest

CASES_DIR = "/root/reference/tests/regression_tests/test_cases"
COMPARE = ["junctions.bed", "insertions.bed", "deletions.bed",
           "accepted_hits.sam", "align_summary.txt"]


def _run_case(case, out_dir, n_devices):
    from tophat_tpu.cli.main import main
    from tophat_tpu.parallel import auto

    case_dir = os.path.join(CASES_DIR, case)
    with open(os.path.join(case_dir, "command.txt")) as f:
        toks = shlex.split(f.read().strip())
    args, i = [], 1
    while i < len(toks):
        if toks[i] in ("-o", "--output-dir"):
            i += 2
            continue
        args.append(toks[i])
        i += 1
    cwd = os.getcwd()
    os.chdir(case_dir)
    os.environ["TOPHAT_TPU_DEVICES"] = str(n_devices)
    try:
        main(["-o", out_dir] + args)
    finally:
        os.chdir(cwd)
        os.environ.pop("TOPHAT_TPU_DEVICES", None)
        auto.deactivate()


@pytest.mark.parametrize("case", ["test_SimpleSplicing", "test_Indel_1",
                                  "test_Paired"])
def test_multidevice_equals_single(case, tmp_path):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the 8-device virtual mesh")
    if not os.path.isdir(os.path.join(CASES_DIR, case)):
        pytest.skip("reference test cases unavailable")
    out1 = str(tmp_path / "dev1")
    out8 = str(tmp_path / "dev8")
    _run_case(case, out1, 1)
    _run_case(case, out8, len(jax.devices()))
    for fname in COMPARE:
        p1, p8 = os.path.join(out1, fname), os.path.join(out8, fname)
        assert os.path.exists(p1) == os.path.exists(p8), fname
        if os.path.exists(p1):
            with open(p1, "rb") as f1, open(p8, "rb") as f8:
                assert f1.read() == f8.read(), (
                    f"{fname} differs between 1-device and multi-device runs")


@pytest.mark.parametrize("case", ["test_SimpleSplicing", "test_Paired"])
def test_genome_sharded_production_equals_single(case, tmp_path):
    """Production pipeline with the FM index range-sharded over the mesh's
    genome axis (parallel/auto.configure_genome_axis forced via
    $TOPHAT_TPU_GENOME_SHARDS) must stay byte-identical to the 1-device
    run (SURVEY §2.5 index-sharding row; VERDICT r2 item 9)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the 8-device virtual mesh")
    if not os.path.isdir(os.path.join(CASES_DIR, case)):
        pytest.skip("reference test cases unavailable")
    from tophat_tpu.parallel import auto

    out1 = str(tmp_path / "dev1")
    outg = str(tmp_path / "sharded")
    _run_case(case, out1, 1)
    os.environ["TOPHAT_TPU_GENOME_SHARDS"] = "2"
    try:
        _run_case(case, outg, len(jax.devices()))
        assert not auto.genome_sharded()  # _run_case deactivates
    finally:
        os.environ.pop("TOPHAT_TPU_GENOME_SHARDS", None)
    for fname in COMPARE:
        p1, pg = os.path.join(out1, fname), os.path.join(outg, fname)
        assert os.path.exists(p1) == os.path.exists(pg), fname
        if os.path.exists(p1):
            with open(p1, "rb") as f1, open(pg, "rb") as f2:
                assert f1.read() == f2.read(), (
                    f"{fname} differs between 1-device and genome-sharded "
                    "runs")


def test_beam_segment_engine_on_mesh(tmp_path):
    """VERDICT r4 #1: the full-sensitivity half-split segment engine must
    run (not silently fall back to pigeonhole) when a mesh is active, and
    its hit tables must be byte-identical to the single-device run — on a
    genome above BEAM_MIN_N with planted 1-mm / same-half and split-pair
    2-mm segment placements (bowtie1 -v 2 contract, reference
    src/tophat.py:2339-2344)."""
    import jax
    import numpy as np

    if len(jax.devices()) < 2:
        pytest.skip("needs the 8-device virtual mesh")
    from tophat_tpu.index.fm import build_fm_index, default_kmer_k
    from tophat_tpu.ops.beam import beam_align_rows
    from tophat_tpu.parallel import auto
    from tophat_tpu.pipeline.segment import BEAM_MIN_N

    rng = np.random.default_rng(31)
    N = BEAM_MIN_N + 1024
    codes = rng.integers(0, 4, N).astype(np.int8)
    fm = build_fm_index(codes, kmer_k=default_kmer_k(N))
    offsets = np.array([0, N], np.int32)

    B, L = 64, 25
    rows = np.zeros((B, L), np.int8)
    lens = np.full(B, L, np.int32)
    planted = []
    for b in range(B):
        p = int(rng.integers(100, N - 100))
        seg = codes[p:p + L].copy()
        kind = b % 4
        if kind == 1:       # 1 mm
            q = int(rng.integers(0, L))
            seg[q] = (seg[q] + 1) % 4
        elif kind == 2:     # same-half 2 mm
            for q in rng.choice(L // 2, 2, replace=False):
                seg[q] = (seg[q] + 1) % 4
        elif kind == 3:     # split-pair 2 mm
            i = int(rng.integers(0, L // 2))
            j = int(rng.integers(L // 2, L))
            seg[i] = (seg[i] + 1) % 4
            seg[j] = (seg[j] + 2) % 4
        rows[b] = seg
        planted.append(p)

    kw = dict(max_mismatches=2, max_hits=16)
    auto.deactivate()
    ref = tuple(np.asarray(a) for a in
                beam_align_rows(fm, rows, lens, offsets, **kw))
    try:
        # replicated-index mesh
        os.environ["TOPHAT_TPU_DEVICES"] = str(len(jax.devices()))
        auto.auto_activate()
        got = tuple(np.asarray(a) for a in
                    beam_align_rows(fm, rows, lens, offsets, **kw))
        for a, b, nm in zip(ref, got,
                            ("pos", "mm", "valid", "n_hits", "trunc")):
            assert np.array_equal(a, b), f"mesh {nm} differs"
        # range-sharded index on the genome axis
        from tophat_tpu.index.fasta import Genome

        genome = Genome(codes=codes, offsets=np.array([0, N]),
                        names=["chrM"])
        os.environ["TOPHAT_TPU_GENOME_SHARDS"] = "2"
        auto.configure_genome_axis(fm, genome, 2 * L)
        assert auto.genome_sharded(fm)
        got2 = tuple(np.asarray(a) for a in
                     beam_align_rows(fm, rows, lens, offsets, **kw))
        for a, b, nm in zip(ref, got2,
                            ("pos", "mm", "valid", "n_hits", "trunc")):
            assert np.array_equal(a, b), f"genome-sharded {nm} differs"
    finally:
        os.environ.pop("TOPHAT_TPU_DEVICES", None)
        os.environ.pop("TOPHAT_TPU_GENOME_SHARDS", None)
        auto.deactivate()
    for b in range(B):
        got_pos = set(ref[0][b][ref[2][b]])
        assert planted[b] in got_pos, f"row {b}: planted hit missed"
