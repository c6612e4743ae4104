"""50k-feature scale headroom probe (VERDICT r4 item 8): 50 families x
1000 alleles (3kb, ~25 SNPs). Proves the index build, gband sidecar, HBM
placement planner, and the wide-W engine hold beyond the 20k flagship:
records build time, table footprints, the single-chip engine bring-up, a
correctness pass on family-attributable reads, and the chained device
rate."""
import sys, time
sys.path.insert(0, ".")
import numpy as np

N_FAMILIES = 50
ALLELES_PER_FAMILY = 1000
ALLELE_LEN = 3000
SNPS = 25
READ_LEN = 100
K = 21


def main():
    import jax, jax.numpy as jnp

    from nimble_tpu import accel

    accel.compile_cache_dir()

    from nimble_tpu import seq as seqmod
    from nimble_tpu.config import Config, Data
    from nimble_tpu.index.builder import KmerIndex, build_index
    from nimble_tpu.align.engine import AlignEngine, align_step
    from nimble_tpu.parallel.mesh import plan_index_placement

    rng = np.random.default_rng(0)
    data = Data()
    backbones = []
    t0 = time.time()
    for fam in range(N_FAMILIES):
        bb = rng.integers(0, 4, size=ALLELE_LEN).astype(np.int8)
        backbones.append(bb)
        for a in range(ALLELES_PER_FAMILY):
            s = bb.copy()
            pos = rng.integers(0, ALLELE_LEN, size=SNPS)
            s[pos] = rng.integers(0, 4, size=SNPS).astype(np.int8)
            data.columns[0].append("scale50k")
            data.columns[1].append(f"F{fam:02d}*{a:04d}")
            data.columns[2].append(str(ALLELE_LEN))
            data.columns[3].append(seqmod.decode(s))
    print(f"library built in {time.time()-t0:.1f}s", file=sys.stderr, flush=True)

    config = Config()
    import pathlib

    cache = pathlib.Path(".bench_data/big50k.idx.npz")
    t0 = time.time()
    if cache.exists():
        index = KmerIndex.load(str(cache))
    else:
        index = build_index(data, config, k=K)
        cache.parent.mkdir(exist_ok=True)
        index.save(str(cache))
    t_build = time.time() - t0
    table_bytes = (index.table_hi.nbytes + index.table_lo.nbytes
                   + index.table_vsame.nbytes + index.table_vdiff.nbytes)
    print(
        f"index: {index.n_kmers} kmers, {index.n_classes} classes, "
        f"{index.n_features} features, W={index.bitset_words}, built in "
        f"{t_build:.1f}s; table {table_bytes/1e9:.2f} GB, class_bits "
        f"{index.class_bits.nbytes/1e9:.2f} GB",
        flush=True,
    )
    print(plan_index_placement(index, hbm_bytes_per_chip=accel.memory_bytes(),
                               n_chips=8), flush=True)

    # family-attributable reads: from allele-specific SNP neighborhoods so
    # correctness is checkable (the read's source family must be in the
    # reported features' families)
    n_reads = 1 << 14
    fam = rng.integers(0, N_FAMILIES, size=n_reads)
    st = rng.integers(0, ALLELE_LEN - READ_LEN + 1, size=n_reads)
    bb = np.stack(backbones)
    idx2 = st[:, None] + np.arange(READ_LEN)[None, :]
    codes = bb[fam[:, None], idx2].astype(np.int8)
    rc = rng.random(n_reads) < 0.5
    codes[rc] = seqmod.revcomp_codes(codes[rc])
    lens = np.full(n_reads, READ_LEN, dtype=np.int32)

    t0 = time.time()
    engine = AlignEngine(index, config, chunk_size=None, max_len=READ_LEN)
    print(f"engine up in {time.time()-t0:.1f}s; chunk={engine.chunk_size} "
          f"S={engine.scan_chunks} banded={engine._banded_wire} "
          f"idlist={engine._idlist_wire}", flush=True)

    chunk = engine.chunk_size
    reps = -(-chunk // n_reads)
    c = np.tile(codes, (reps, 1))[:chunk]
    l = np.tile(lens, reps)[:chunk]
    c_dev = jax.device_put(c)
    l_dev = jax.device_put(l)
    t0 = time.time()
    r = engine._fn(engine.tables, c_dev, l_dev)
    jax.block_until_ready(r)
    print(f"compile+first chunk: {time.time()-t0:.1f}s; "
          f"pass {float(np.asarray(jnp.reshape(r['pass_'], (-1,))).mean()):.3f}",
          flush=True)

    # correctness: every clean backbone read either fails (error-free reads
    # can't fail here) or reports features exclusively from its own family
    bits = np.ascontiguousarray(np.asarray(r["bits"])[: n_reads])
    pass_ = np.asarray(jnp.reshape(r["pass_"], (-1,)))[: n_reads]
    from nimble_tpu.align.pipeline import decode_bitsets

    member = decode_bitsets(bits.view(np.uint32), index.n_features)
    n_checked = n_wrong = 0
    for i in range(n_reads):
        if not pass_[i]:
            continue
        feats = np.nonzero(member[i])[0]
        if feats.size == 0:
            continue
        fams = {index.feature_names[f].split("*")[0] for f in feats}
        n_checked += 1
        if fams != {f"F{fam[i]:02d}"}:
            n_wrong += 1
    print(f"correctness: {n_checked} pass reads checked, {n_wrong} with "
          f"out-of-family features", flush=True)
    assert n_wrong == 0, n_wrong

    # chained device rate (bigindex.py methodology)
    p_eng = engine.params
    fn_sum = jax.jit(
        lambda t, cc, ll, eps: jnp.sum(align_step(t, p_eng, cc, ll)["score"]) + eps
    )
    eps0 = jax.device_put(jnp.int32(0))
    _ = int(fn_sum(engine.tables, c_dev, l_dev, eps0))
    best = 1e9
    for epoch in range(3):
        for _ in range(3):
            t0 = time.time()
            eps = eps0
            for _ in range(8):
                eps = fn_sum(engine.tables, c_dev, l_dev, eps)
            _ = int(eps)
            best = min(best, (time.time() - t0) / 8)
        print(f"  epoch {epoch}: best {best*1000:.2f} ms/chunk", flush=True)
        if epoch < 2:
            time.sleep(15)
    print(f"50k-feature chained: {best*1000:.2f} ms/chunk({chunk}) = "
          f"{chunk/best/1e6:.3f} M reads/s/chip", flush=True)


if __name__ == "__main__":
    main()
