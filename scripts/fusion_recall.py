#!/usr/bin/env python
"""Fusion end-to-end recall harness, mirroring the reference's
fusion_test/run_test.sh: for each synthetic read set, run the pipeline with
fusion search and report found/total (unique read names in accepted_hits).

Usage: python scripts/fusion_recall.py [set ...]   (default: all 16)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FT = "/root/reference/fusion_test"


def run_set(fasta, out_root, fm_cache):
    from tophat_tpu.cli.main import main

    out = os.path.join(out_root, os.path.basename(fasta))
    main(["-o", out, "--fusion-search", "--bowtie1",
          "--fusion-do-not-resolve-conflicts", "--max-intron-length", "500",
          "--fusion-min-dist", "500",
          os.path.join(FT, "testcases", "test.fa"), fasta])
    total = sum(1 for l in open(fasta) if l.startswith(">"))
    names = set()
    with open(os.path.join(out, "accepted_hits.sam")) as f:
        for line in f:
            if not line.startswith("@"):
                names.add(line.split("\t", 1)[0])
    return len(names), total


def main_cli():
    sets = sys.argv[1:] or sorted(
        f for f in os.listdir(FT) if f.endswith(".fasta"))
    out_root = tempfile.mkdtemp(prefix="fusion_recall_")
    grand_found = grand_total = 0
    for s in sets:
        found, total = run_set(os.path.join(FT, s), out_root, None)
        grand_found += found
        grand_total += total
        print(f"{s}: {found}/{total}")
    print(f"TOTAL: {grand_found}/{grand_total} "
          f"({100.0 * grand_found / max(grand_total, 1):.1f}%)")


if __name__ == "__main__":
    main_cli()
