#!/usr/bin/env python
"""Run the reference regression cases and diff against the checked-in gold
outputs (reference: tests/regression_tests/regression_test.py protocol).

Usage: python scripts/regress.py [case ...]   (default: all)
"""

import difflib
import os
import shlex
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES_DIR = "/root/reference/tests/regression_tests/test_cases"
ALL_CASES = [
    "test_SimpleSplicing", "test_3Segment", "test_ReverseComplementSplicing",
    "test_SimpleIndel", "test_Indel_1", "test_IndelWithErrors",
    "test_IndelLowerCase", "test_ReverseComplementIndel", "test_Paired",
]
COMPARE = ["junctions.bed", "insertions.bed", "deletions.bed",
           "accepted_hits.sam"]


def parse_command(case_dir):
    with open(os.path.join(case_dir, "command.txt")) as f:
        toks = shlex.split(f.read().strip())
    assert toks[0] == "tophat"
    args = []
    i = 1
    while i < len(toks):
        t = toks[i]
        if t in ("-o", "--output-dir"):
            i += 2
            continue
        args.append(t)
        i += 1
    # the checked-in golds were produced by the TopHat 1.1.4 driver; run
    # the CLI with its defaults (novel indels opt-in via --allow-indels)
    args.append("--v114-defaults")
    return args


def check_nm_consistency(sam_path, fasta_path):
    """The reference harness runs `samtools calmd` on accepted_hits.bam and
    requires zero stderr (regression_test.py:96-107) — i.e. every record's
    bases/CIGAR/NM must be consistent with the reference sequence. Recompute
    NM (mismatches + inserted + deleted bases) from the genome and compare.
    Returns a list of inconsistent read names."""
    import re

    from tophat_tpu.index.fasta import encode_seq, read_fasta

    genome = read_fasta(fasta_path)
    name2id = genome.name_to_id()
    bad = []
    for line in open(sam_path):
        if line.startswith("@"):
            continue
        t = line.rstrip("\n").split("\t")
        name, flag, ref, pos, cigar, seq = (t[0], int(t[1]), t[2],
                                            int(t[3]) - 1, t[5], t[9])
        nm_tag = next((int(f[5:]) for f in t[11:] if f.startswith("NM:i:")),
                      None)
        if nm_tag is None or ref not in name2id:
            continue
        g = genome.codes[int(genome.offsets[name2id[ref]]):]
        codes = encode_seq(seq)
        nm = 0
        gp = pos
        rp = 0
        for ln, op in re.findall(r"(\d+)([MIDNS])", cigar):
            ln = int(ln)
            if op == "M":
                a = codes[rp:rp + ln]
                b = g[gp:gp + ln]
                nm += int((a != b[: len(a)]).sum()) + max(0, ln - len(b))
                gp += ln
                rp += ln
            elif op == "I":
                nm += ln
                rp += ln
            elif op == "D":
                nm += ln
                gp += ln
            elif op == "N":
                gp += ln
            elif op == "S":
                rp += ln
        if nm != nm_tag:
            bad.append(f"{name}: NM:i:{nm_tag} but recomputed {nm} ({cigar})")
    return bad


def run_case(case, out_root):
    case_dir = os.path.join(CASES_DIR, case)
    args = parse_command(case_dir)
    out_dir = os.path.join(out_root, case)
    cwd = os.getcwd()
    os.chdir(case_dir)
    try:
        from tophat_tpu.cli.main import main
        main(["-o", out_dir] + args)
    finally:
        os.chdir(cwd)
    results = {}
    mine_sam = os.path.join(out_dir, "accepted_hits.sam")
    if os.path.exists(mine_sam):
        bad = check_nm_consistency(
            mine_sam, os.path.join(CASES_DIR, "common_genomes", "fake.fa"))
        results["calmd(NM-consistency)"] = (
            None if not bad else [f"+{b}\n" for b in bad])
    for fname in COMPARE:
        gold = os.path.join(case_dir, "tophat_out", fname)
        mine = os.path.join(out_dir, fname)
        if not os.path.exists(gold):
            continue
        with open(gold) as f:
            gold_lines = f.readlines()
        mine_lines = open(mine).readlines() if os.path.exists(mine) else []
        if gold_lines == mine_lines:
            results[fname] = None
        else:
            diff = list(difflib.unified_diff(gold_lines, mine_lines,
                                             "gold", "mine", lineterm="\n"))
            results[fname] = diff
    return results


def main_cli():
    cases = sys.argv[1:] or ALL_CASES
    out_root = tempfile.mkdtemp(prefix="tophat_tpu_regress_")
    print(f"outputs in {out_root}")
    summary = {}
    for case in cases:
        print(f"=== {case}")
        try:
            results = run_case(case, out_root)
        except Exception as e:
            import traceback
            traceback.print_exc()
            summary[case] = {"ERROR": str(e)}
            continue
        summary[case] = results
        for fname, diff in results.items():
            if diff is None:
                print(f"  {fname}: IDENTICAL")
            else:
                nadd = sum(1 for l in diff if l.startswith("+") and
                           not l.startswith("+++"))
                ndel = sum(1 for l in diff if l.startswith("-") and
                           not l.startswith("---"))
                print(f"  {fname}: DIFF (+{nadd}/-{ndel})")
                for line in diff[:14]:
                    print("    " + line.rstrip())
    print("\n==== summary")
    npass = 0
    for case, results in summary.items():
        if "ERROR" in results:
            status = "ERROR"
        elif all(v is None for v in results.values()):
            status = "PASS"
            npass += 1
        else:
            status = ("FAIL: "
                      + ",".join(k for k, v in results.items() if v))
        print(f"  {case}: {status}")
    print(f"{npass}/{len(summary)} cases fully identical")


if __name__ == "__main__":
    main_cli()
