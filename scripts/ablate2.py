"""Per-stage ablation on the bench workload (two-choice probe path): jit
progressively longer prefixes of the align step over the same
device-resident chunk, each reduced to one scalar so the call cannot return
before its work is done, and subtract.

Usage: python scripts/ablate2.py
"""
import pathlib, sys, time
import numpy as np, jax, jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from bench import build_workload
from nimble_tpu import accel
from nimble_tpu.align import engine as E

accel.compile_cache_dir()
CHUNK = 1 << 16

index, config, codes, lens = build_workload()
tables = E._device_tables(index)
p = E.AlignParams.from_config(config, index)
c_dev = jax.device_put(codes[:CHUNK])
l_dev = jax.device_put(lens[:CHUNK])


def force(x):
    leaves = jax.tree_util.tree_leaves(x)
    return sum(
        jnp.sum(l.astype(jnp.int32)) if l.dtype == jnp.bool_ else jnp.sum(l)
        for l in leaves
    )


def variant_kmer(t, c, l):
    hi, lo, valid = E.kmer_hi_lo(c, l, p.k)
    return E._bitcast_i32(hi), E._bitcast_i32(lo), valid


def variant_lookup(t, c, l):
    hi, lo, valid = E.kmer_hi_lo(c, l, p.k)
    return E.lookup_classes(hi, lo, valid, t, p.n_buckets, p.k)


def variant_lookup_cov(t, c, l):
    hi, lo, valid = E.kmer_hi_lo(c, l, p.k)
    cls_f, cls_r = E.lookup_classes(hi, lo, valid, t, p.n_buckets, p.k)
    return (E.coverage_score(cls_f >= 0, l, p.k, c.shape[1]),
            E.coverage_score(cls_r >= 0, l, p.k, c.shape[1]))


def variant_lookup_isect(t, c, l):
    hi, lo, valid = E.kmer_hi_lo(c, l, p.k)
    cls_f, cls_r = E.lookup_classes(hi, lo, valid, t, p.n_buckets, p.k)
    return (E.intersect_class_bits(cls_f, cls_f >= 0, t["class_bits"]),
            E.intersect_class_bits(cls_r, cls_r >= 0, t["class_bits"]))


def variant_mate(t, c, l):
    return E._score_mate(c, l, t, p)


def variant_full(t, c, l):
    return E.align_step(t, p, c, l)


for name, fn in [
    ("kmer", variant_kmer),
    ("kmer+lookup", variant_lookup),
    ("kmer+lookup+cov", variant_lookup_cov),
    ("kmer+lookup+isect", variant_lookup_isect),
    ("mate(fwd+rev)", variant_mate),
    ("full", variant_full),
]:
    jf = jax.jit(lambda t, c, l, fn=fn: force(fn(t, c, l)))
    t0 = time.time()
    _ = int(jf(tables, c_dev, l_dev))
    comp = time.time() - t0
    N = 16
    t0 = time.time()
    acc = 0
    for _ in range(N):
        acc = acc + jf(tables, c_dev, l_dev)
    _ = int(acc)
    dt = (time.time() - t0) / N
    print(
        f"{name:20s} compile {comp:6.1f}s  {dt*1e3:8.2f} ms/chunk  "
        f"{CHUNK/dt/1e6:6.2f} M reads/s",
        flush=True,
    )
