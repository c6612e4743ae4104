"""Scale validation: index build for a ~20k-allele HLA/KIR-class library
(BASELINE.json config 3). Host-side build + memory accounting; optional
device align smoke when run with an accelerator."""
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

from nimble_tpu import seq as seqmod
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import build_index
from nimble_tpu import accel
from nimble_tpu.parallel.mesh import plan_index_placement

N_GENES = 20
ALLELES_PER_GENE = 1000  # 20k total
LEN = 3000

rng = np.random.default_rng(0)
data = Data()
t0 = time.time()
for g in range(N_GENES):
    gene_backbone = rng.integers(0, 4, size=LEN).astype(np.int8)
    for a in range(ALLELES_PER_GENE):
        s = gene_backbone.copy()
        pos = rng.integers(0, LEN, size=20)
        s[pos] = rng.integers(0, 4, size=20).astype(np.int8)
        data.columns[0].append("hla kir full")
        data.columns[1].append(f"G{g:02d}*{a:04d}")
        data.columns[2].append(str(LEN))
        data.columns[3].append(seqmod.decode(s))
print(f"generated {len(data)} alleles in {time.time()-t0:.1f}s", flush=True)

t0 = time.time()
index = build_index(data, Config(), k=21)
build_s = time.time() - t0
table_mb = (index.table_hi.nbytes + index.table_lo.nbytes
            + index.table_vsame.nbytes + index.table_vdiff.nbytes) / 1e6
class_mb = index.class_bits.nbytes / 1e6
print(
    f"built in {build_s:.1f}s: {index.n_kmers} canonical kmers, "
    f"{index.n_classes} classes, W={index.bitset_words}, "
    f"table {table_mb:.0f} MB, class_bits {class_mb:.0f} MB",
    flush=True,
)
plan = plan_index_placement(index, hbm_bytes_per_chip=accel.memory_bytes(), n_chips=8)
print("placement plan:", plan, flush=True)
