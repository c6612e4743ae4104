"""Materialize the wide-library workload for a full `align` CLI run: the
library of bigindex.py (N families x 1000 alleles, 3kb, ~25 SNPs; 20
families by default) written as a [Config, Data] JSON, plus a gzipped
FASTQ of backbone reads with 1% substitution error, half
reverse-complemented.

Usage: python scripts/make_big20k_cli.py OUTDIR [N_READS] [N_FAMILIES]
"""
import gzip
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, pathlib.Path(__file__).resolve().parents[1].as_posix())
sys.path.insert(0, pathlib.Path(__file__).resolve().parent.as_posix())

from bigindex import ALLELE_LEN, N_FAMILIES, READ_LEN, build_library  # noqa: E402

ERROR_RATE = 0.01


def write_library(outdir: pathlib.Path, n_families: int = N_FAMILIES):
    """Write big20k.json for n_families families; returns (path, backbones)."""
    from nimble_tpu.config import Config

    data, backbones = build_library(n_families)
    lib_path = outdir / "big20k.json"
    with open(lib_path, "w") as f:
        json.dump([Config().to_dict(), data.__dict__], f)
    return lib_path, backbones


def write_reads(outdir: pathlib.Path, backbones, n_reads: int):
    """Gzipped FASTQ of n_reads backbone reads (seed 7); returns its path."""
    from nimble_tpu import seq as seqmod

    bb_mat = np.stack(backbones)
    n_fam = len(backbones)
    fq_path = outdir / f"reads20k_{n_reads}.fastq.gz"
    base_lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = b"I" * READ_LEN
    chunk = 1 << 17
    rng = np.random.default_rng(7)
    with gzip.open(fq_path, "wb", compresslevel=1) as f:
        written = 0
        while written < n_reads:
            n = min(chunk, n_reads - written)
            fam = rng.integers(0, n_fam, size=n)
            st = rng.integers(0, ALLELE_LEN - READ_LEN + 1, size=n)
            idx = st[:, None] + np.arange(READ_LEN)[None, :]
            codes = bb_mat[fam[:, None], idx].astype(np.int8)
            err = rng.random((n, READ_LEN)) < ERROR_RATE
            codes = np.where(
                err, rng.integers(0, 4, size=codes.shape), codes
            ).astype(np.int8)
            rc = rng.random(n) < 0.5
            codes[rc] = seqmod.revcomp_codes(codes[rc])
            seqs = base_lut[codes]
            lines = []
            for i in range(n):
                lines.append(
                    b"@r%d\n%s\n+\n%s\n"
                    % (written + i, seqs[i].tobytes(), qual)
                )
            f.write(b"".join(lines))
            written += n
    return fq_path


def main():
    outdir = pathlib.Path(sys.argv[1])
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 2_000_000
    n_families = int(sys.argv[3]) if len(sys.argv) > 3 else N_FAMILIES
    outdir.mkdir(parents=True, exist_ok=True)
    lib_path, backbones = write_library(outdir, n_families)
    print(f"library: {lib_path}")
    print(f"reads: {write_reads(outdir, backbones, n_reads)}")


if __name__ == "__main__":
    main()
