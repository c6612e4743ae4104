#!/usr/bin/env python3
"""Smoke run of nimble_tpu's main path on the GPU, through the CLI.

    python chip_smoke.py               # one card: the default phases
    python chip_smoke.py --four-cards  # the multi-card paths, four cards

Run it from the root of a checkout. This process never imports JAX: every
step is a `python -m nimble_tpu ...` child, one at a time, so only one
process holds a card (the four-card multi-process phase starts one child
per card). Every GPU result is compared with the same CLI run on the CPU
(children with JAX_PLATFORMS=cpu) or, for the four-card paths, with the
one-card run made in the same call. All data is made from fixed seeds by
the repository's own generators.

Default phases:
  1. narrow library (HLA-100), single-end: generate from FASTA -> index
     --warm 100 -> align 2,000,000 gzipped reads; the TSV rows of the first
     65,536 reads must be byte-identical to the CPU's;
  2. 10x chain: fastq-to-bam with a whitelist -> align the tagged BAM ->
     report (exact host path) and report --device; device counts must
     equal the exact ones except where the tie guard flags near-ties;
  3. wide library (gband path): 20 families x 1000 alleles, 1,000,000
     reads; the first 16,384 reads' rows byte-identical to the CPU's;
  4. --probe mono, a num_mismatches=1 library and a two-library run (the
     stacked engine), each byte-identical to the CPU on 16,384 reads.

A failed phase exits non-zero. Without a GPU it exits non-zero before any
phase. The last line of a passing run is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
Times printed are single smoke runs, not benchmark numbers.
"""
import argparse
import gzip
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
PY = sys.executable

N_NARROW = 2_000_000
CMP_NARROW = 65_536
N_PAIRS = 500_000
CMP_PAIRS = 65_536
WIDE_FAMILIES = 20
N_WIDE = 1_000_000
CMP_SMALL = 16_384
FOUR_FAMILIES = 5  # wide library of the four-card phase
N_FOUR = 131_072


class PhaseFailed(Exception):
    pass


def say(*args):
    print(*args, flush=True)


def child(args, cpu=False, env=None, timeout=1500, label=None):
    """Run `python <args>` from the checkout root; raise on failure. GPU
    children echo the device line the CLI prints."""
    e = dict(os.environ)
    if cpu:
        e["JAX_PLATFORMS"] = "cpu"
    e.update(env or {})
    t0 = time.time()
    r = subprocess.run(
        [PY, *map(str, args)], cwd=ROOT, env=e, capture_output=True,
        text=True, timeout=timeout,
    )
    dt = time.time() - t0
    if r.returncode != 0:
        raise PhaseFailed(
            f"{label or args}: exit {r.returncode}\n{r.stdout[-3000:]}\n"
            f"{r.stderr[-6000:]}"
        )
    if not cpu:
        for line in r.stderr.splitlines():
            if line.startswith(("device:", "WARNING")):
                say(f"  [{label or args[2]}] {line}")
    return r, dt


def cli(*args, **kw):
    return child(["-m", "nimble_tpu", *args], **kw)


def head_fastq(src, dst, n):
    """First n records of a (gzipped) FASTQ."""
    with gzip.open(src, "rb") as f, gzip.open(dst, "wb", compresslevel=1) as g:
        for _ in range(4 * n):
            line = f.readline()
            if not line:
                break
            g.write(line)
    return dst


def tsv_rows(path):
    with open(path, "rb") as f:
        return sum(1 for _ in f) - 1


def same_prefix(cpu_tsv, gpu_tsv, what, ref="the CPU"):
    """The reference TSV of the first n reads (the CPU's, or the one-card
    run's) must be the GPU TSV's first rows, byte for byte (rows are
    emitted in read order)."""
    a = pathlib.Path(cpu_tsv).read_bytes()
    b = pathlib.Path(gpu_tsv).read_bytes()
    if tsv_rows(cpu_tsv) < 1:
        raise PhaseFailed(f"{what}: {ref} reported no rows")
    if b[: len(a)] != a or (len(b) > len(a) and b[len(a) - 1 : len(a)] != b"\n"):
        raise PhaseFailed(f"{what}: GPU TSV differs from {ref}")
    say(f"  {what}: {tsv_rows(cpu_tsv)} rows byte-identical to {ref}")


def engine_event(runlog):
    path = pathlib.Path(runlog)
    events = [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []
    eng = [e for e in events if e["event"] in ("engine", "stacked_engine")]
    return eng[-1] if eng else {}


def gpu_align(work, name, ref, inputs, extra=(), reads=None):
    """GPU `align`; prints rows, pass rate, engine path and the smoke time."""
    runlog = work / f"{name}.runlog.jsonl"
    out = work / f"{name}.gpu.tsv"
    _, dt = cli(
        "align", "--reference", ref, "--output", out, "--input", *inputs,
        "-c", str(os.cpu_count() or 1), *extra,
        env={"NIMBLE_TPU_RUNLOG": str(runlog)}, label=f"align {name}",
    )
    ev = engine_event(runlog)
    rows = tsv_rows(out) if out.exists() else None
    rate = f", pass rate {rows / reads:.4f}" if reads and rows is not None else ""
    say(
        f"  align {name}: {rows} rows{rate}; engine "
        f"{ev.get('path', 'stacked' if ev else '?')} wire {ev.get('wire', '-')} "
        f"chunk {ev.get('chunk', '-')} x {ev.get('scan_chunks', '-')}; "
        f"smoke time {dt:.1f} s (one run, compile included; not a benchmark)"
    )
    return out, ev


def cpu_align(work, name, ref, inputs, extra=()):
    out = work / f"{name}.cpu.tsv"
    cli(
        "align", "--reference", ref, "--output", out, "--input", *inputs,
        "-c", str(os.cpu_count() or 1), *extra, cpu=True,
        label=f"cpu align {name}",
    )
    return out


def narrow_library(work, n_reads):
    """HLA-100 through `generate` from a FASTA: (library JSON, reads)."""
    child(["scripts/make_bench_fastq.py", work, n_reads], cpu=True,
          label="make_bench_fastq")
    lib = json.loads((work / "hla100.json").read_text())
    data = lib[1]["columns"]
    with open(work / "hla100.fasta", "w") as f:
        for name, seq in zip(data[1], data[3]):
            f.write(f">{name}\n{seq}\n")
    cli("generate", "--file", work / "hla100.fasta", "--output_path",
        work / "lib.json", cpu=True, label="generate")
    return work / "lib.json", work / f"reads_{n_reads}.fastq.gz"


def phase_narrow(work, lib, reads):
    say("phase 1: narrow library, single-end")
    _, dt = cli("index", "--reference", lib, "--warm", "100", label="index --warm")
    say(f"  index --warm 100: {dt:.1f} s (set-up, compile included)")
    gpu_tsv, ev = gpu_align(work, "narrow", lib, [reads], reads=N_NARROW)
    head = head_fastq(reads, work / "narrow_head.fastq.gz", CMP_NARROW)
    same_prefix(cpu_align(work, "narrow", lib, [head]), gpu_tsv,
                f"narrow, first {CMP_NARROW} reads")


def report_counts(path):
    rows = pathlib.Path(path).read_text().splitlines()
    return set(rows)


def phase_10x(work, lib):
    say("phase 2: 10x paired chain")
    child(["scripts/make_paired_bench.py", work, N_PAIRS], cpu=True,
          label="make_paired_bench")
    r1 = work / f"paired_r1_{N_PAIRS}.fastq.gz"
    r2 = work / f"paired_r2_{N_PAIRS}.fastq.gz"
    bam = work / "tagged.bam"
    _, dt = cli("fastq-to-bam", "--r1-fastq", r1, "--r2-fastq", r2, "--map",
                work / "whitelist.txt", "--output", bam, "-c",
                str(os.cpu_count() or 1), cpu=True, label="fastq-to-bam")
    say(f"  fastq-to-bam {N_PAIRS} pairs: {dt:.1f} s")
    tsv, _ = gpu_align(work, "paired", lib, [bam], reads=N_PAIRS)
    cli("report", "-i", tsv, "-o", work / "counts.host.tsv", cpu=True,
        label="report")
    r, _ = cli("report", "--device", "-i", tsv, "-o", work / "counts.dev.tsv",
               label="report --device")
    flagged = 0
    for line in r.stderr.splitlines():
        if line.startswith("WARNING:") and "threshold" in line:
            flagged += int(line.split()[1])
    host = report_counts(work / "counts.host.tsv")
    dev = report_counts(work / "counts.dev.tsv")
    diff = len(host ^ dev)
    say(f"  report: {len(host)} count rows; device differs in {diff} rows; "
        f"tie guard flagged {flagged} (group, feature) ratios")
    if len(host) < 2:
        raise PhaseFailed("10x: the exact report has no counts")
    # one flipped (group, feature) decision moves one UMI between two
    # count rows, so at most two differing rows per flagged ratio
    if diff > 2 * flagged:
        raise PhaseFailed(f"10x: {diff} unflagged count differences")


def wide_library(work, families, n_reads):
    child(["scripts/make_big20k_cli.py", work, n_reads, families], cpu=True,
          label="make_big20k_cli")
    return work / "big20k.json", work / f"reads20k_{n_reads}.fastq.gz"


def phase_wide(work):
    say(f"phase 3: wide library ({WIDE_FAMILIES} x 1000 alleles), gband path")
    lib, reads = wide_library(work, WIDE_FAMILIES, N_WIDE)
    _, dt = cli("index", "--reference", lib, "--warm", "100",
                label="index --warm (wide)")
    say(f"  index --warm 100 (index, gband sidecar, compile): {dt:.1f} s set-up")
    gpu_tsv, ev = gpu_align(work, "wide", lib, [reads], reads=N_WIDE)
    if ev.get("path") != "gband":
        raise PhaseFailed(f"wide: engine path {ev.get('path')!r}, not gband")
    head = head_fastq(reads, work / "wide_head.fastq.gz", CMP_SMALL)
    same_prefix(cpu_align(work, "wide", lib, [head]), gpu_tsv,
                f"wide, first {CMP_SMALL} reads")


def phase_small_paths(work, lib, reads):
    say("phase 4: other paths at small size")
    head = head_fastq(reads, work / "small.fastq.gz", CMP_SMALL)
    mono = work / "mono.json"
    shutil.copy(lib, mono)
    gpu, ev = gpu_align(work, "mono", mono, [head], extra=["--probe", "mono"])
    if ev.get("path") != "mono":
        raise PhaseFailed(f"--probe mono: engine path {ev.get('path')!r}")
    same_prefix(cpu_align(work, "mono", mono, [head], extra=["--probe", "mono"]),
                gpu, "--probe mono")

    cfg, data = json.loads(pathlib.Path(lib).read_text())
    cfg["num_mismatches"] = 1
    mm = work / "mm1.json"
    mm.write_text(json.dumps([cfg, data]))
    gpu, _ = gpu_align(work, "mm1", mm, [head])
    same_prefix(cpu_align(work, "mm1", mm, [head]), gpu, "num_mismatches=1")

    cfg, data = json.loads(pathlib.Path(lib).read_text())
    half = dict(data, columns=[col[: len(col) // 2] for col in data["columns"]])
    a, b = work / "liba.json", work / "libb.json"
    shutil.copy(lib, a)
    b.write_text(json.dumps([cfg, half]))
    refs = f"{a},{b}"
    gpu, ev = gpu_align(work, "stack", refs, [head])
    if ev.get("event") != "stacked_engine":
        raise PhaseFailed("two libraries: the stacked engine did not run")
    cpu_align(work, "stack", refs, [head])
    for tag in ("liba", "libb"):
        same_prefix(work / f"stack.{tag}.cpu.tsv", work / f"stack.{tag}.gpu.tsv",
                    f"two libraries ({tag})")


def four_cards(work, lib, reads):
    """Multi-card paths, each byte-identical to the one-card run."""
    say("four cards: mesh, multi-process and distributed report")
    wlib, wreads = wide_library(work, FOUR_FAMILIES, N_FOUR)
    cli("index", "--reference", wlib, label="index (wide)")
    one, _ = gpu_align(work, "wide1", wlib, [wreads])
    mesh, _ = gpu_align(work, "wide4", wlib, [wreads], extra=["--mesh", "data=4"])
    same_prefix(one, mesh, "align --mesh data=4 (wide) vs one card", ref="the one-card run")

    mono = work / "mono4.json"
    shutil.copy(lib, mono)
    one, _ = gpu_align(work, "mono1", mono, [reads], extra=["--probe", "mono"])
    fs, _ = gpu_align(work, "monofs", mono, [reads],
                       extra=["--probe", "mono", "--mesh", "data=2,feature=2"])
    same_prefix(one, fs, "align --mesh data=2,feature=2 (class table) vs one card", ref="the one-card run")

    out = work / "mp.gpu.tsv"
    procs = []
    t0 = time.time()
    try:
        for pid in range(4):
            e = dict(os.environ, NIMBLE_TPU_NUM_PROCS="4", NIMBLE_TPU_PROC_ID=str(pid))
            procs.append(subprocess.Popen(
                [PY, "-m", "nimble_tpu", "align", "--reference", wlib, "--output",
                 out, "--input", wreads], cwd=ROOT, env=e,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for pid, p in enumerate(procs):
            _, se = p.communicate(timeout=600)
            for line in se.splitlines():
                if line.startswith("device:"):
                    say(f"  [process {pid}] {line}")
            if p.returncode:
                raise PhaseFailed(
                    f"multi-process align {pid}: exit {p.returncode}\n{se[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    say(f"  4-process align: {time.time() - t0:.1f} s")
    same_prefix(work / "wide1.gpu.tsv", out,
                "NIMBLE_TPU_NUM_PROCS=4 align vs one card", ref="the one-card run")

    child(["scripts/make_paired_bench.py", work, CMP_PAIRS], cpu=True,
          label="make_paired_bench")
    bam = work / "tagged4.bam"
    cli("fastq-to-bam", "--r1-fastq", work / f"paired_r1_{CMP_PAIRS}.fastq.gz",
        "--r2-fastq", work / f"paired_r2_{CMP_PAIRS}.fastq.gz", "--map",
        work / "whitelist.txt", "--output", bam, cpu=True, label="fastq-to-bam")
    tsv, _ = gpu_align(work, "paired4", lib, [bam], reads=CMP_PAIRS)
    cli("report", "--device", "-i", tsv, "-o", work / "c1.tsv", label="report --device")
    cli("report", "--distributed", "4", "-i", tsv, "-o", work / "c4.tsv",
        label="report --distributed 4")
    if (work / "c1.tsv").read_bytes() != (work / "c4.tsv").read_bytes():
        raise PhaseFailed("report --distributed 4 differs from the one-card report --device")
    say(f"  report --distributed 4: {tsv_rows(work / 'c4.tsv') + 1} rows identical to one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four cards")
    args = ap.parse_args()
    if not (ROOT / "nimble_tpu" / "__main__.py").exists():
        say(f"chip_smoke.py must run from a nimble_tpu checkout ({ROOT})")
        return 2

    r, _ = child(["-c", (
        "import json, jax; d = jax.devices(); print(json.dumps({'platform': "
        "d[0].platform, 'kind': d[0].device_kind, 'count': len(d), 'jax': "
        "jax.__version__}))")], label="device query")
    dev = json.loads(r.stdout.strip().splitlines()[-1])
    say(f"jax {dev['jax']}: platform {dev['platform']}, kind {dev['kind']}, "
        f"count {dev['count']}")
    if dev["platform"] != "gpu":
        say(f"no GPU: JAX's platform is {dev['platform']!r}")
        return 1
    want = 4 if args.four_cards else 1
    if dev["count"] < want:
        say(f"needs {want} card(s), JAX sees {dev['count']}")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    say(f"card: {card}")

    make = subprocess.run(["make", "-C", "native", "-B"], cwd=ROOT,
                          capture_output=True, text=True)
    if make.returncode != 0:
        say(f"native build failed:\n{make.stdout[-2000:]}\n{make.stderr[-3000:]}")
        return 1
    say("native library rebuilt from native/nimble_native.cpp")

    work = pathlib.Path(tempfile.mkdtemp(prefix=".smoke_", dir=ROOT))
    t0 = time.time()
    try:
        lib, reads = narrow_library(work, 4 * CMP_SMALL if args.four_cards else N_NARROW)
        if args.four_cards:
            four_cards(work, lib, reads)
        else:
            phase_narrow(work, lib, reads)
            phase_10x(work, lib)
            phase_wide(work)
            phase_small_paths(work, lib, reads)
    except (PhaseFailed, subprocess.SubprocessError, OSError) as e:
        say(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"all phases passed in {time.time() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
