"""Multi-library throughput: stacked GROUP probe (one gather stream answers
every library) vs per-library engine sweeps, on the bench's HLA-100-shaped
workload replicated into L libraries. The reference aligns L libraries in
one pass over the reads but probes each index per read (one -r/-o pair per
library, nimble/__main__.py:182-189); the stack's advantage compounds with
L because probe rows — the dominant cost — stay constant."""
import pathlib, sys, time

import numpy as np

_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
sys.path.insert(0, _ROOT)
import jax
import jax.numpy as jnp

import bench as B
from nimble_tpu import accel

accel.compile_cache_dir()
from nimble_tpu import seq as seqmod
from nimble_tpu.align.engine import AlignEngine
from nimble_tpu.align.stacked import StackedEngine
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import build_index

L_LIBS = 3
N_PER_LIB = 40  # smaller per-library feature spaces so the stack fits


def lib_workload(seed):
    rng = np.random.default_rng(seed)
    backbone = rng.integers(0, 4, size=B.ALLELE_LEN).astype(np.int8)
    data = Data()
    alleles = []
    for i in range(N_PER_LIB):
        s = backbone.copy()
        pos = rng.integers(0, B.ALLELE_LEN, size=30)
        s[pos] = rng.integers(0, 4, size=30).astype(np.int8)
        alleles.append(s)
        data.columns[0].append(f"lib{seed}")
        data.columns[1].append(f"l{seed}a{i:03d}")
        data.columns[2].append(str(B.ALLELE_LEN))
        data.columns[3].append(seqmod.decode(s))
    return data, alleles


def main():
    datas, all_alleles = zip(*(lib_workload(s) for s in range(L_LIBS)))
    configs = [Config() for _ in range(L_LIBS)]
    t0 = time.time()
    indexes = [build_index(d, c, k=B.K) for d, c in zip(datas, configs)]
    print(f"{L_LIBS} indexes built in {time.time()-t0:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(9)
    n_reads = 1 << 16
    codes = np.empty((n_reads, B.READ_LEN), dtype=np.int8)
    for i in range(n_reads):
        src = all_alleles[i % L_LIBS]
        a = src[rng.integers(0, N_PER_LIB)]
        st = rng.integers(0, B.ALLELE_LEN - B.READ_LEN + 1)
        codes[i] = a[st : st + B.READ_LEN]
    err = rng.random(codes.shape) < 0.01
    codes = np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)
    rc = np.random.default_rng(1).random(n_reads) < 0.5
    codes[rc] = seqmod.revcomp_codes(codes[rc])
    lens = np.full(n_reads, B.READ_LEN, dtype=np.int32)

    def burst_rate(fn, tables, chunk, label):
        c = np.tile(codes, (max(1, chunk // n_reads + 1), 1))[:chunk]
        l = np.full(chunk, B.READ_LEN, dtype=np.int32)
        c_dev, l_dev = jax.device_put(c), jax.device_put(l)
        t0 = time.time()
        out = fn(tables, c_dev, l_dev)
        jax.block_until_ready(out)
        print(f"  {label}: compile {time.time()-t0:.1f}s", file=sys.stderr)
        best = 1e9
        for _ in range(12):
            t0 = time.time()
            acc = None
            for _ in range(4):
                o = fn(tables, c_dev, l_dev)
                s = o["score"] if isinstance(o, dict) else sum(x["score"] for x in o)
                acc = s if acc is None else acc + s
            _ = int(jnp.sum(acc))
            best = min(best, (time.time() - t0) / 4)
        return chunk / best

    stacked = StackedEngine(indexes, configs, chunk_size=None, max_len=B.READ_LEN)
    print(
        f"stacked: group_g={stacked.group_g} chunk={stacked.chunk_size} "
        f"seg_words={stacked.seg_words}",
        file=sys.stderr,
    )
    r = burst_rate(stacked._fn, stacked.tables, stacked.chunk_size, "stacked")
    print(f"stacked group ({L_LIBS} libs): {r/1e6:.2f} M reads/s/chip")

    engines = [
        AlignEngine(ix, c, chunk_size=None, max_len=B.READ_LEN)
        for ix, c in zip(indexes, configs)
    ]
    chunk = min(e.chunk_size for e in engines)

    def sweep(unused, c_dev, l_dev):
        return [e._fn(e.tables, c_dev, l_dev) for e in engines]

    r = burst_rate(sweep, None, chunk, "per-lib sweep")
    print(f"per-library sweep ({L_LIBS} libs): {r/1e6:.2f} M reads/s/chip")


if __name__ == "__main__":
    main()
