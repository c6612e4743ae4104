"""nimble_tpu CLI — drop-in replacement for the reference's subcommand surface
(reference: nimble/__main__.py:373-468): download (compat no-op), generate,
align, report, plot, fastq-to-bam; plus the nimble_tpu extension: index
(prebuild + persist the device index, optionally AOT-precompiling the
align dispatch programs via --warm).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nimble_tpu", description="nimble_tpu align")
    from nimble_tpu import __version__

    parser.add_argument("-v", "--version", action="version", version=f"nimble_tpu {__version__}")
    subparsers = parser.add_subparsers(title="subcommands", dest="subcommand")

    # download: the reference fetches a prebuilt Rust binary; our aligner is
    # built in. Kept for pipeline compatibility.
    download_parser = subparsers.add_parser("download")
    download_parser.add_argument("--release", type=str, default=[])

    generate_parser = subparsers.add_parser("generate")
    generate_parser.add_argument("--file", help="The file to process.", type=str, required=True)
    generate_parser.add_argument("--opt-file", help="The optional file to process.", type=str, default=None)
    generate_parser.add_argument("--output_path", help="The path to the output file.", type=str, required=True)

    align_parser = subparsers.add_parser("align")
    align_parser.add_argument("--reference", help="Comma-separated library JSON list.", type=str, required=True)
    align_parser.add_argument("--output", help="The path to the output file.", type=str, required=True)
    align_parser.add_argument("--input", help="The input reads (1-2 FASTQs or 1 BAM).", type=str, required=True, nargs="+")
    align_parser.add_argument("-c", "--num_cores", help="Cores for host-side IO.", type=int, default=1)
    align_parser.add_argument("--strand_filter", type=str, default="unstranded")
    align_parser.add_argument("--trim", help="Trim config <TARGET_LENGTH>:<STRICTNESS>, comma-separated per library.", type=str, default="")
    align_parser.add_argument("--tmpdir", help="Accepted for compatibility (no BAM sort needed).", type=str, default=None)
    align_parser.add_argument(
        "--max-read-length", type=int, default=0,
        help="Packed read width (0 = auto from the first batch, capped at "
             "256; explicit values also truncate longer reads).",
    )
    align_parser.add_argument(
        "--chunk-size", type=int, default=0,
        help="Reads per device call (0 = auto-size from the engine path and "
             "HBM transient budget; see align.engine.auto_chunk_size).",
    )
    align_parser.add_argument("--resume", action="store_true", default=False,
                              help="Resume an interrupted run from its .progress.json sidecar.")
    align_parser.add_argument(
        "--mesh", type=str, default="",
        help="Multi-chip mesh spec: 'data=N[,feature=M]' or 'auto' (all "
             "devices on the data axis). Default: single device.",
    )
    align_parser.add_argument(
        "--probe", type=str, default="group", choices=("group", "mono"),
        help="k-mer probe path: 'group' (default; one probe per g=6 read "
             "windows — faster and more error-tolerant, see README "
             "'Probe paths') or 'mono' (per-k-mer probing, the "
             "reference-faithful contract).",
    )

    report_parser = subparsers.add_parser("report")
    report_parser.add_argument("-i", "--input", type=str, required=True)
    report_parser.add_argument("-o", "--output", type=str, required=True)
    report_parser.add_argument("-s", "--summarize", help="CSV list of columns to summarize.", type=str, default=None)
    report_parser.add_argument("-t", "--threshold", type=float, default=0.05)
    report_parser.add_argument("--disable_thresholding", action="store_true", default=False)
    report_parser.add_argument(
        "--device", action="store_true", default=False,
        help="Run the UMI pipeline as XLA segment ops on the accelerator "
             "(quant/device.py) instead of the exact host path.",
    )
    report_parser.add_argument(
        "--distributed", type=int, default=0, metavar="N",
        help="Shard the device UMI pipeline over an N-way data mesh with a "
             "cell-barcode-bucket all-to-all exchange (parallel/dist.py).",
    )
    report_parser.add_argument(
        "--stream", action="store_true", default=None,
        help="Run the exact host pipeline via bounded spill buckets "
             "(quant/stream.py) so inputs larger than RAM work, "
             "bit-identically. Default: auto above "
             "NIMBLE_TPU_REPORT_STREAM_MB (4096).",
    )

    plot_parser = subparsers.add_parser("plot")
    plot_parser.add_argument("--input_file", type=str, required=True)
    plot_parser.add_argument("--output_file", type=str, required=True)

    f2b_parser = subparsers.add_parser("fastq-to-bam")
    f2b_parser.add_argument("--r1-fastq", type=str, required=True)
    f2b_parser.add_argument("--r2-fastq", type=str, required=True)
    f2b_parser.add_argument("--map", required=True, help="Cell barcode whitelist (one CB per line, .gz or plain)")
    f2b_parser.add_argument("--output", type=str, required=True)
    f2b_parser.add_argument("-c", "--num_cores", type=int, default=1)
    f2b_parser.add_argument("--cb-length", type=int, default=16)
    f2b_parser.add_argument("--umi-length", type=int, default=12)

    index_parser = subparsers.add_parser("index", help="Prebuild and persist a device index (.npz)")
    index_parser.add_argument("--reference", type=str, required=True)
    index_parser.add_argument(
        "--output", type=str, default=None,
        help="Output .npz (default: the <reference>.idx.npz sidecar that `align` auto-loads)",
    )
    index_parser.add_argument("--kmer-length", type=int, default=None)
    index_parser.add_argument(
        "--probe", type=str, default="group", choices=("group", "mono"),
        help="Probe path the index is built for (must match the later "
             "`align --probe`; see align --help).",
    )
    index_parser.add_argument(
        "--warm", type=int, default=0, metavar="READ_LEN", nargs="?", const=100,
        help="AOT-precompile the align dispatch programs for reads of this "
             "length (default 100 when given bare) into the persistent "
             "compile cache, so the first `align` run doesn't pay minutes "
             "of serial compiles on a fresh library geometry.",
    )
    index_parser.add_argument(
        "--paired", action="store_true", default=False,
        help="With --warm: precompile the paired-end (R1+R2 / BAM) "
             "programs instead of single-end.",
    )
    index_parser.add_argument(
        "--chunk-size", type=int, default=0,
        help="With --warm: chunk size to precompile for (0 = the auto "
             "size `align --chunk-size 0` would pick).",
    )
    index_parser.add_argument(
        "--strand_filter", type=str, default="unstranded",
        help="With --warm: strand filter the programs are compiled for "
             "(must match the later `align --strand_filter` — the filter "
             "is baked into the traced program and its cache key).",
    )

    args = parser.parse_args(argv)

    if args.subcommand == "download":
        print("nimble_tpu's aligner is built in; nothing to download.")
        return 0
    if args.subcommand == "generate":
        from nimble_tpu.library import generate

        generate(args.file, args.opt_file, args.output_path)
        return 0
    if args.subcommand == "align":
        from nimble_tpu.align.pipeline import align_files

        return align_files(
            args.reference,
            args.output,
            args.input,
            strand_filter=args.strand_filter,
            chunk_size=args.chunk_size or None,
            max_len=args.max_read_length,
            resume=args.resume,
            trim=args.trim,
            mesh=args.mesh,
            num_cores=args.num_cores,
            probe=args.probe,
        )
    if args.subcommand == "report":
        from nimble_tpu.report.tsv import report

        summarize_columns_list = args.summarize.split(",") if args.summarize else None
        engine = "host"
        if args.distributed > 0:
            engine = "distributed"
        elif args.device:
            engine = "device"
        report(
            args.input,
            args.output,
            summarize_columns_list,
            args.threshold,
            args.disable_thresholding,
            engine=engine,
            dist_shards=args.distributed,
            stream=args.stream,
        )
        return 0
    if args.subcommand == "plot":
        from nimble_tpu.report.plots import plot_command

        plot_command(args.input_file, args.output_file)
        return 0
    if args.subcommand == "fastq-to-bam":
        from nimble_tpu.barcode import fastq_to_bam_with_barcodes

        fastq_to_bam_with_barcodes(
            args.r1_fastq,
            args.r2_fastq,
            args.map,
            args.output,
            args.num_cores,
            args.cb_length,
            args.umi_length,
        )
        return 0
    if args.subcommand == "index":
        from nimble_tpu.config import load_library
        from nimble_tpu.index.builder import (
            build_index,
            index_cache_key,
            index_cache_path,
        )

        config, data = load_library(args.reference)
        group_g = 0 if args.probe == "mono" else None
        idx = build_index(data, config, k=args.kmer_length, group_g=group_g)
        out = args.output or index_cache_path(args.reference)
        # stamp the content-hash key so `align` trusts and reuses the file
        idx.save(
            out,
            cache_key=index_cache_key(args.reference, args.kmer_length, group_g),
        )
        print(
            f"Indexed {idx.n_kmers} k-mers, {idx.n_features} features, "
            f"{idx.n_classes} classes -> {out}"
        )
        if args.warm:
            # mirror align's engine construction exactly (auto max_len
            # rounding, auto chunk size) so the compiled programs' cache
            # keys match what the first real `align` run will look up
            import time as _time

            from nimble_tpu import accel
            from nimble_tpu.align.engine import AlignEngine
            from nimble_tpu.align.pipeline import _round_len

            accel.compile_cache_dir()
            t0 = _time.time()
            engine = AlignEngine(
                idx,
                config,
                strand_filter=args.strand_filter,
                chunk_size=args.chunk_size or None,
                max_len=min(_round_len(args.warm), 256),
                paired=args.paired,
            )
            n = engine.warmup()
            print(
                f"Warmed {n} dispatch program(s) (read_len {args.warm}, "
                f"chunk {engine.chunk_size} x {engine.scan_chunks}, "
                f"{args.strand_filter}, "
                f"{'paired' if args.paired else 'single-end'}) in "
                f"{_time.time() - t0:.1f}s"
            )
        return 0

    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
