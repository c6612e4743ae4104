"""Generic in-process engine A/B on the 20k-allele workload: build one
gband engine per env-variant, then interleave best-of bursts (compare two
variants only within one run).

Usage: python scripts/ab_engine_envs.py CHUNK name1=ENV=V[,ENV=V...] name2=...
e.g.   python scripts/ab_engine_envs.py 65536 ind= dense=NIMBLE_TPU_GBAND_INDIRECT=0
"""
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from nimble_tpu import accel

    accel.compile_cache_dir()

    from nimble_tpu.align.engine import AlignEngine
    from nimble_tpu.config import Config
    from bigindex import get_index, READ_LEN

    chunk = int(sys.argv[1])
    variants = []
    for spec in sys.argv[2:]:
        name, _, envs = spec.partition("=")
        pairs = [e.split("=", 1) for e in envs.split(",") if e]
        variants.append((name, pairs))

    index, backbones = get_index()
    rng = np.random.default_rng(7)
    codes = np.empty((chunk, READ_LEN), dtype=np.int8)
    for i in range(chunk):
        bb = backbones[i % len(backbones)]
        st = rng.integers(0, len(bb) - READ_LEN + 1)
        codes[i] = bb[st:st + READ_LEN]
    err = rng.random(codes.shape) < 0.01
    codes = np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)
    from nimble_tpu import seq as seqmod
    rc = np.random.default_rng(1).random(chunk) < 0.5
    codes[rc] = seqmod.revcomp_codes(codes[rc])
    lens = np.full(chunk, READ_LEN, dtype=np.int32)
    c_dev = jax.device_put(codes)
    l_dev = jax.device_put(lens)

    engines = {}
    saved = {}
    for name, pairs in variants:
        for k, v in pairs:
            saved.setdefault(k, os.environ.get(k))
            os.environ[k] = v
        t0 = time.time()
        eng = AlignEngine(index, Config(), chunk_size=chunk,
                          max_len=READ_LEN, scan_chunks=1)
        r = eng._fn(eng.tables, c_dev, l_dev)
        jax.block_until_ready(r["score"])
        pr = float(np.asarray(jnp.mean(r["pass_"].astype(jnp.float32))))
        print(f"{name}: build+compile+first {time.time()-t0:.0f}s "
              f"pass {pr:.3f} tables "
              f"{sum(np.asarray(v).size for v in eng.tables.values())*4/1e6:.0f} MB",
              flush=True)
        engines[name] = eng
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    best = {m: 1e9 for m in engines}
    for rnd in range(12):
        for m, eng in engines.items():
            t0 = time.time()
            acc = None
            for _ in range(3):
                s = eng._fn(eng.tables, c_dev, l_dev)["score"]
                acc = s if acc is None else acc + s
            _ = int(jnp.sum(acc))
            best[m] = min(best[m], (time.time() - t0) / 3)
        print(f"round {rnd}: " + "  ".join(
            f"{m}={best[m]*1000:.1f}ms ({chunk/best[m]/1e6:.3f}M/s)"
            for m in best), flush=True)


if __name__ == "__main__":
    main()
