"""Generate the frozen aligner-contract goldens.

The engine's scoring semantics reproduce a contract [inferred] from the
reference frontend (reference: nimble/__main__.py:177-196 argv surface,
nimble/report_generation.py:275-288 TSV columns); the Rust backend itself
cannot be run here (zero egress). This script pins that inferred contract
as DATA: a committed synthetic paired-end workload plus one committed
library JSON + align-TSV golden per Config field at non-default values
(reference: nimble/types.py:10-26). tests/test_goldens.py byte-diffs live
CLI output against these files, so any semantic drift in any probe path
fails CI with a file diff instead of a re-derived assertion.

Regenerate (ONLY for deliberate semantic changes): python scripts/make_goldens.py
"""
import json
import os
import pathlib
import shutil
import sys

# goldens must be generated on CPU exactly like the test suite runs them
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, pathlib.Path(__file__).resolve().parents[1].as_posix())

GOLD = pathlib.Path(__file__).resolve().parents[1] / "tests" / "goldens"

READ_LEN = 100

# Config deltas per case; None value = handled specially below.
# Every reference Config field (nimble/types.py:10-26) appears at a
# non-default value in at least one case.
CASES = {
    "base": {},
    "score_threshold_40": {"score_threshold": 40},
    "score_filter_60": {"score_filter": 60},
    "score_percent_08": {"score_percent": 0.8},
    "mismatch1": {"num_mismatches": 1},
    "mismatch2": {"num_mismatches": 2},
    "discard_multiple": {"discard_multiple_matches": True},
    "intersect1": {"intersect_level": 1},
    "intersect2": {"intersect_level": 2},
    "group_on_lineage": {"group_on": "lineage"},
    "multi_hits_2": {"discard_multi_hits": 2},
    "require_valid_pair": {"require_valid_pair": True},
    "max_hits_1": {"max_hits_to_report": 1},
    "trim_60": {"trim_target_length": 60, "trim_strictness": 1.0},
    "data_type_dna": {"data_type": "DNA"},
    "filters_minct": {
        "filters": [
            {"name": "minPct", "value": 0.05},
            {"name": "minCount", "value": 150},
        ]
    },
}
# cases run with extra CLI flags instead of a Config delta
FLAG_CASES = {
    "probe_mono": ["--probe", "mono"],
    "strand_fiveprime": ["--strand_filter", "fiveprime"],
}
SINGLE_END_CASES = {"strand_fiveprime"}


def build_workload():
    from nimble_tpu import seq as seqmod
    from nimble_tpu.config import Data

    rng = np.random.default_rng(1234)

    def rand(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))

    # 2 families x 3 alleles sharing a family backbone, each allele with a
    # unique 40bp variant block at position 200
    fams = {}
    seqs = {}
    for fam in "AB":
        bb = rand(500)
        fams[fam] = bb
        for i in range(1, 4):
            s = list(bb)
            s[200:240] = list(rand(40))
            seqs[f"{fam.lower()}{i}"] = "".join(s)

    data = Data()
    data.headers.append("lineage")
    data.columns.append([])
    for name, s in seqs.items():
        data.columns[0].append("golden_lib")
        data.columns[1].append(name)
        data.columns[2].append(str(len(s)))
        data.columns[3].append(s)
        data.columns[4].append("fam" + name[0].upper())

    # Read-pair stimuli. R2 is the reverse complement of a region ~120bp
    # downstream of R1 on the same source unless stated otherwise.
    def mate(src, start):
        return seqmod.revcomp(src[start : start + READ_LEN])

    pairs = []  # (name, r1_seq, r2_seq)

    def add(name, r1, r2):
        pairs.append((name, r1, r2))

    for a in ("a1", "a2", "a3", "b1", "b2"):
        src = seqs[a]
        # unique-block read: hits exactly {a}
        add(f"uniq_{a}", src[170:270], mate(src, 290))
    # backbone read: hits all 3 family-A alleles (multi-hit stimulus)
    add("backboneA", seqs["a1"][300:400], mate(seqs["a1"], 400))
    add("backboneB", seqs["b1"][300:400], mate(seqs["b1"], 400))
    # reverse-complemented R1 (strand stimulus)
    add("rc_a2", seqmod.revcomp(seqs["a2"][170:270]), mate(seqs["a2"], 290))
    # 1 and 2 substitutions inside the unique block
    r = list(seqs["a1"][170:270])
    r[50] = "A" if r[50] != "A" else "C"
    add("mm1_a1", "".join(r), mate(seqs["a1"], 290))
    r = list(seqs["a1"][170:270])
    r[40] = "A" if r[40] != "A" else "C"
    r[75] = "G" if r[75] != "G" else "T"
    add("mm2_a1", "".join(r), mate(seqs["a1"], 290))
    # short read (pads to READ_LEN with junk at the reader level? no —
    # FASTQ records carry true length; 30bp matching b2's block)
    add("short_b2", seqs["b2"][205:235], mate(seqs["b2"], 290))
    # partial match: 70bp of a3 + 30bp junk (score_percent stimulus)
    add("part70_a3", seqs["a3"][170:240] + rand(30), mate(seqs["a3"], 290))
    # 40bp of a3 + 60 junk (score_filter / score_percent stimulus)
    add("part40_a3", seqs["a3"][190:230] + rand(60), mate(seqs["a3"], 290))
    # discordant mates: R1 in a1's block, R2 in b1's block
    add("discord", seqs["a1"][170:270], mate(seqs["b1"], 170))
    # R2 unmappable junk
    add("r2junk_a2", seqs["a2"][170:270], rand(READ_LEN))
    # R1 junk, R2 maps to b3
    add("r1junk_b3", rand(READ_LEN), mate(seqs["b3"], 170))
    # weak pair: 35bp match + 15bp junk R1 (score ~35: passes
    # score_threshold 20 / score_percent 0.5 / score_filter 25, fails
    # score_filter 60), junk R2
    add("weak_b2", seqs["b2"][205:240] + rand(15), rand(50))
    # N runs inside the read
    r = list(seqs["a1"][170:270])
    r[55:59] = list("NNNN")
    add("withN_a1", "".join(r), mate(seqs["a1"], 290))
    # long overhang read for trim: 100bp whose last 40bp cross into junk
    add("trimtail_b1", seqs["b1"][180:240] + rand(40), mate(seqs["b1"], 290))
    return data, pairs


def main():
    from nimble_tpu.__main__ import main as cli
    from nimble_tpu.config import Config
    from nimble_tpu.io.fastq import write_fastq

    GOLD.mkdir(parents=True, exist_ok=True)
    data, pairs = build_workload()

    r1 = [(f"{n}/1", s1, "I" * len(s1)) for n, s1, _ in pairs]
    r2 = [(f"{n}/2", s2, "I" * len(s2)) for n, _, s2 in pairs]
    write_fastq(str(GOLD / "r1.fastq"), r1)
    write_fastq(str(GOLD / "r2.fastq"), r2)

    outputs = {}
    for case, delta in CASES.items():
        cfg = Config()
        for k, v in delta.items():
            setattr(cfg, k, v)
        lib = GOLD / f"lib_{case}.json"
        with open(lib, "w") as f:
            json.dump([cfg.to_dict(), data.to_dict()], f, indent=1)
        out = GOLD / f"golden_{case}.tsv"
        flags = FLAG_CASES.get(case, [])
        inputs = [str(GOLD / "r1.fastq")]
        if case not in SINGLE_END_CASES:
            inputs.append(str(GOLD / "r2.fastq"))
        rc = cli(
            ["align", "--reference", str(lib), "--output", str(out),
             "--input", *inputs, *flags]
        )
        assert rc == 0, case
        outputs[case] = out.read_bytes()

    for case, flags in FLAG_CASES.items():
        lib = GOLD / "lib_base.json"
        out = GOLD / f"golden_{case}.tsv"
        inputs = [str(GOLD / "r1.fastq")]
        if case not in SINGLE_END_CASES:
            inputs.append(str(GOLD / "r2.fastq"))
        rc = cli(
            ["align", "--reference", str(lib), "--output", str(out),
             "--input", *inputs, *flags]
        )
        assert rc == 0, case
        outputs[case] = out.read_bytes()

    # legacy bulk filter-chain golden (Config.filters consumer,
    # reference: nimble/reporting.py / parse.py:39-57)
    from nimble_tpu.legacy import bulk_report, parse_filter_config

    methods, values = parse_filter_config(str(GOLD / "lib_filters_minct.json"))
    bulk_report(
        methods,
        values,
        str(GOLD / "golden_base.tsv"),
        str(GOLD / "golden_legacy_filters.tsv"),
    )

    # sanity: a case whose golden equals base pins nothing — report it
    base = outputs.pop("base")
    same = [c for c, b in outputs.items() if b == base]
    for c in sorted(outputs):
        n = len(outputs[c].splitlines())
        print(f"{c:24s} rows={n - 1:3d} {'== base' if c in same else 'differs'}")
    if same:
        print(f"NOTE: cases identical to base: {same}", file=sys.stderr)

    # drop the index sidecars the align runs left next to the libraries
    for p in GOLD.glob("*.idx.npz"):
        p.unlink()


if __name__ == "__main__":
    main()
