"""In-process A/B: fused dual-orientation coverage (coverage_score2) vs
two coverage_score calls, on the 20k gband engine. Interleaved bursts:
compare two variants only within one run.

Usage: python scripts/ab_cov2.py [CHUNK]
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

    chunk = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
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
    for mode, env in (("fused", ""), ("twocall", "1")):
        os.environ["NIMBLE_TPU_NO_COV2"] = env
        t0 = time.time()
        eng = AlignEngine(index, Config(), chunk_size=chunk,
                          max_len=READ_LEN, scan_chunks=1)
        r = eng._fn(eng.tables, c_dev, l_dev)
        jax.block_until_ready(r["score"])
        pr = float(np.asarray(jnp.mean(r["pass_"].astype(jnp.float32))))
        print(f"{mode}: build+compile+first {time.time()-t0:.0f}s pass {pr:.3f}",
              flush=True)
        engines[mode] = eng

    best = {m: 1e9 for m in engines}
    for rnd in range(10):
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
