"""The wide HLA/KIR-shaped library: N_FAMILIES gene families x 1000
alleles (3 kb, ~25 SNPs per allele off a family backbone), the workload of
the wide-W engine path (W=625 words at 20 families, banded group probe).

build_library() makes it in memory from seed 0; get_index() builds its
k=21 index once and keeps it at .bench_data/big20k.idx.npz. The first
n_families of a smaller library are exactly those of the 20-family one.
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import numpy as np

N_FAMILIES = 20
ALLELES_PER_FAMILY = 1000
ALLELE_LEN = 3000
SNPS = 25
READ_LEN = 100
K = 21
CACHE = pathlib.Path(".bench_data/big20k.idx.npz")


def build_library(n_families: int = N_FAMILIES):
    """(Data, backbones) for n_families x ALLELES_PER_FAMILY alleles."""
    from nimble_tpu import seq as seqmod
    from nimble_tpu.config import Data

    rng = np.random.default_rng(0)
    data = Data()
    backbones = []
    for fam in range(n_families):
        bb = rng.integers(0, 4, size=ALLELE_LEN).astype(np.int8)
        backbones.append(bb)
        for a in range(ALLELES_PER_FAMILY):
            s = bb.copy()
            pos = rng.integers(0, ALLELE_LEN, size=SNPS)
            s[pos] = rng.integers(0, 4, size=SNPS).astype(np.int8)
            data.columns[0].append("hla_kir_20k")
            data.columns[1].append(f"F{fam:02d}*{a:04d}")
            data.columns[2].append(str(ALLELE_LEN))
            data.columns[3].append(seqmod.decode(s))
    return data, backbones


def get_index():
    """(index, backbones) of the 20-family library, index cached on disk."""
    from nimble_tpu.config import Config
    from nimble_tpu.index.builder import KmerIndex, build_index

    data, backbones = build_library()
    if CACHE.exists():
        return KmerIndex.load(str(CACHE)), backbones
    t0 = time.time()
    index = build_index(data, Config(), k=K)
    print(f"index built in {time.time()-t0:.1f}s", file=sys.stderr)
    CACHE.parent.mkdir(exist_ok=True)
    index.save(str(CACHE))
    return index, backbones
