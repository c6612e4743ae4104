"""Device stage timings of the align step on the GPU, from jax.profiler
traces and block_until_ready timings, for the kernel decisions in PERF.md:

  copy    a large copy (the byte bound every stage is compared with);
  window  the window stage (engine.window_keys) alone: time, kernels, bytes;
  band    band tree + expand (engine.band_tree_expand) alone;
  mono    the mono probe's gather + slot select alone;
  hla     HLA-100 (bench.py's workload) full scanned step: per-scope trace
          breakdown and compiled memory;
  wide    the 20-family wide library (scripts/bigindex.py): index and gband
          sidecar build time, per-scope trace breakdown and compiled memory;
  sweep   device-resident reads/s of the CLI's packed dispatch over chunk
          {16384, 65536, 131072} x scan {1, 8}, HLA-100 and the wide library.

Usage: python scripts/stage_profile.py OUTDIR [SECTION,...] [SIZE_DIV] [WIDE_LIB]
Writes OUTDIR/stage_profile.json and one trace summary per traced program.
SIZE_DIV divides every batch size (a CPU rehearsal at tiny shapes).
WIDE_LIB: the wide library's JSON (scripts/make_big20k_cli.py) whose
persisted index and gband sidecar (`index --warm`) are loaded, not rebuilt.
Numbers are only device numbers when the platform line says gpu.
"""
import glob
import json
import pathlib
import subprocess
import sys
import time
import traceback

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nimble_tpu import accel  # noqa: E402
from nimble_tpu.align import engine as E  # noqa: E402

RESULTS = {}
DIV = 1
WIDE_LIB = None
OUT = pathlib.Path(".")


def log(*a):
    print(*a, flush=True)


def best_time(fn, *args, reps=5, inner=3):
    """Best over reps of the mean of `inner` back-to-back calls, each
    ending in block_until_ready."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            r = fn(*args)
        jax.block_until_ready(r)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


SCOPES = ("band_tree", "window", "coverage")


def _fusion_scopes(fn, *args):
    """Kernel name -> named scope, from the op_name metadata of the
    optimized HLO's top-level instructions (kernel events carry only the
    fusion's name, with '.' as '_')."""
    import re

    text = fn.lower(*args).compile().as_text()
    out = {}
    for m in re.finditer(r"%([\w.\-]+) = [^\n]*?metadata=\{[^}]*op_name=\"([^\"]*)\"", text):
        name, op = m.group(1), m.group(2)
        for sc in SCOPES:
            if f"/{sc}/" in op or op.endswith(f"/{sc}"):
                out[name.replace(".", "_")] = sc
                break
    return out


def trace(name, fn, *args, calls=3):
    """Device events of `calls` calls of fn, grouped by named scope."""
    logdir = OUT / f"trace_{name}"
    scope_of = _fusion_scopes(fn, *args) if hasattr(fn, "lower") else {}
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(str(logdir)):
        for _ in range(calls):
            r = fn(*args)
        jax.block_until_ready(r)
    files = sorted(glob.glob(str(logdir / "plugins/profile/*/*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(files[-1])
    by_scope, by_kernel, n_events = {}, {}, 0
    lines_out, line_totals = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            line_totals[f"{plane.name} {line.name}"] = sum(
                ev.duration_ns for ev in line.events) / 1e3 / calls
            # kernel events sit on the stream lines; "XLA Modules" and
            # "XLA Ops" lines repeat the same time at coarser grain
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                stats = " ".join(str(v) for _, v in ev.stats)
                scope = scope_of.get(ev.name, "other")
                us = ev.duration_ns / 1e3 / calls
                by_scope[scope] = by_scope.get(scope, 0.0) + us
                by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + us
                n_events += 1
                lines_out.append(f"{line.name}\t{ev.name}\t{ev.duration_ns}\t{stats[:300]}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    (OUT / f"trace_{name}.txt").write_text("\n".join(lines_out[:4000]))
    res = {
        "line_us_per_call": {k: round(v, 1) for k, v in line_totals.items()},
        "device_us_per_call_by_scope": {k: round(v, 1) for k, v in by_scope.items()},
        "kernels_per_call": n_events / calls,
        "top_kernels_us": [(k, round(v, 1)) for k, v in top],
    }
    log(f"  trace {name}: {json.dumps(res['device_us_per_call_by_scope'])}, "
        f"{res['kernels_per_call']:.0f} kernels/call")
    for k, v in top[:10]:
        log(f"    {v:10.1f} us  {k}")
    return res


def section(fn):
    def run():
        log(f"== {fn.__name__}")
        t0 = time.time()
        try:
            RESULTS[fn.__name__] = fn()
        except Exception:
            RESULTS[fn.__name__] = {"error": traceback.format_exc()}
            log(traceback.format_exc())
        log(f"   ({time.time() - t0:.1f} s)")
    run.__name__ = fn.__name__
    return run


@section
def copy():
    n = (256 << 20) // DIV
    x = jnp.ones((n,), jnp.int32)
    f = jax.jit(lambda a: a + 1)
    t = best_time(f, x)
    gbs = 2 * 4 * n / t / 1e9
    log(f"  copy {4 * n / 2**20:.0f} MiB read + write: {t * 1e3:.3f} ms = {gbs:.1f} GB/s")
    RESULTS["copy_GBps"] = gbs
    return {"bytes": 8 * n, "s": t, "GBps": gbs}


def _codes(B, L, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    c[rng.random(c.shape) < 0.01] = 4
    return jnp.asarray(c), jnp.full((B,), L, jnp.int32)


@section
def window():
    out = {}
    B, L = 65536 // DIV, 100
    codes, lens = _codes(B, L)
    for k in (21, 26):  # mono k-mers; the group path's (k+g-1)-mers
        f = jax.jit(lambda c, l, k=k: E.window_keys(c, l, k, 1 << 22))
        t = best_time(f, codes, lens)
        P = L - k + 1
        nbytes = B * L + B * P * (4 * 4 + 3)
        gbs = nbytes / t / 1e9
        tr = trace(f"window_k{k}", f, codes, lens)
        share = gbs / RESULTS.get("copy_GBps", float("nan"))
        log(f"  window k={k}: {t * 1e6:.1f} us per {B} reads, {nbytes / 1e6:.1f} MB "
            f"-> {gbs:.1f} GB/s = {share:.2f} of the copy rate")
        out[f"k{k}"] = {"us": t * 1e6, "bytes": nbytes, "GBps": gbs,
                        "copy_share": share, "trace": tr}
    return out


def _brow(B, n, Pw, W, seed=3):
    rng = np.random.default_rng(seed)
    n_pages = -(-W // Pw)
    # family-run structure: one page per read, bands mostly repeated
    page = np.repeat(rng.integers(0, n_pages, size=(B, 1)), n, axis=1).astype(np.int32)
    base = rng.integers(0, 1 << 31, size=(B, 1, 2 * Pw), dtype=np.int64)
    flip = rng.random((B, n, 2 * Pw)) < 0.02
    band = np.where(flip, 0, base).astype(np.int32)
    has = rng.random((B, n)) < 0.9
    brow = np.concatenate([page[..., None], band], axis=-1)
    return jnp.asarray(brow), jnp.asarray(has)


@section
def band():
    B, n, Pw, W = 65536 // DIV, 14, 32, 625
    brow, has = _brow(B, n, Pw, W)
    plain = jax.jit(lambda b, h: E.band_tree_expand(b, h, W, Pw))
    nbytes = B * n * (1 + 2 * Pw) * 4 + B * n + B * W * 4
    t = best_time(plain, brow, has)
    log(f"  band tree+expand: {t * 1e6:.1f} us per {B} reads "
        f"({nbytes / t / 1e9:.1f} GB/s)")
    return {"bytes": nbytes, "us": t * 1e6, "trace": trace("band", plain, brow, has)}


HLA = {}


def _hla():
    if not HLA:
        import bench as B

        HLA["workload"] = B.build_workload()
    return HLA["workload"]


def _hla_engine(chunk, scan):
    index, config, codes, lens = _hla()
    eng = E.AlignEngine(index, config, chunk_size=chunk, max_len=100,
                        scan_chunks=scan)
    return eng, codes, lens


@section
def mono():
    index, config, codes, lens = _hla()
    tables = E._device_tables(index, group_ok=False)
    W = index.bitset_words
    C = 65536 // DIV
    c = jnp.asarray(codes[:C])
    l = jnp.asarray(lens[:C])
    hi, lo, valid = jax.jit(lambda c, l: E.kmer_hi_lo(c, l, index.k))(c, l)
    f = jax.jit(lambda t, h, o, v: E.lookup_mono_bits(h, o, v, t, index.k, W))
    t = best_time(f, tables, hi, lo, valid)
    log(f"  mono probe (canonical + hash + gather + select), W={W}: "
        f"{t * 1e6:.1f} us per {C} reads")
    return {"us": t * 1e6, "W": W, "trace": trace("mono", f, tables, hi, lo, valid)}


def _span_args(eng, codes, lens):
    """Device-resident packed args of one dispatch (one span or chunk)."""
    from nimble_tpu.io.packing import pack_batch

    S, C = eng.scan_chunks, eng.chunk_size
    n = S * C
    reps = -(-n // codes.shape[0])
    pb = pack_batch({"r1_codes": np.tile(codes, (reps, 1))[:n],
                     "r1_lens": np.tile(lens, reps)[:n]}, eng.max_len)
    if S > 1:
        sparse, a = eng._mate_span_args(pb["r1_words"], pb["r1_lens"],
                                        pb["r1_nidx"], pb["r1_nrows"], 0, n, n)
        fn = eng._scan_fn_packed if sparse else eng._scan_fn_packed_dense
    else:
        Lf = (eng.max_len + 31) // 32
        dense = np.zeros((n, Lf), dtype=np.int32)
        dense[pb["r1_nidx"]] = pb["r1_nrows"]
        a = (pb["r1_words"], pb["r1_lens"].astype(np.int16), dense)
        fn = eng._fn_packed_in
    return fn, jax.device_put(a), n


def _step(name, eng, codes, lens, do_trace=True):
    fn, args, n = _span_args(eng, codes, lens)
    t0 = time.time()
    compiled = fn.lower(eng.tables, *args).compile()
    compile_s = time.time() - t0
    mem = compiled.memory_analysis()
    t = best_time(fn, eng.tables, *args)
    res = {"reads": n, "s": t, "reads_per_s": n / t, "compile_s": compile_s,
           "path": eng.probe_path, "wire": eng.wire,
           "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
           "arg_bytes": getattr(mem, "argument_size_in_bytes", None)}
    log(f"  {name}: path {eng.probe_path} wire {eng.wire} chunk {eng.chunk_size} x "
        f"{eng.scan_chunks}: {t * 1e3:.2f} ms per {n} reads = {n / t / 1e6:.3f} M reads/s "
        f"(device-resident); compile {compile_s:.1f} s; temp "
        f"{res['temp_bytes'] and res['temp_bytes'] / 2**30:.2f} GiB, args "
        f"{res['arg_bytes'] and res['arg_bytes'] / 2**30:.2f} GiB")
    if do_trace:
        res["trace"] = trace(name, fn, eng.tables, *args)
    return res


@section
def hla():
    eng, codes, lens = _hla_engine(65536 // DIV, 8)
    return _step("hla_c65536_s8", eng, codes, lens)


WIDE = {}


def _wide():
    if not WIDE:
        import bigindex as BI
        from nimble_tpu.config import Config
        from nimble_tpu.index.builder import build_index
        from nimble_tpu import seq as seqmod

        t0 = time.time()
        data, backbones = BI.build_library(BI.N_FAMILIES // min(DIV, 5))
        t_lib = time.time() - t0
        t0 = time.time()
        if WIDE_LIB:  # the library JSON of make_big20k_cli.py: its persisted index
            from nimble_tpu.config import load_library
            from nimble_tpu.index.builder import build_index_for_library

            config, data = load_library(WIDE_LIB)
            index = build_index_for_library(WIDE_LIB, data, config)
        else:
            index = build_index(data, Config(), k=BI.K)
        t_index = time.time() - t0
        t0 = time.time()
        tables = E._device_tables(index)
        jax.block_until_ready(tables)
        t_tables = time.time() - t0
        log(f"  wide library: {index.n_features} features, W={index.bitset_words}; "
            f"library {t_lib:.1f} s, index {t_index:.1f} s, device tables incl. gband "
            f"sidecar {t_tables:.1f} s")
        rng = np.random.default_rng(7)
        n = 1 << 16
        bb = np.stack(backbones)
        fam = rng.integers(0, len(backbones), size=n)
        st = rng.integers(0, BI.ALLELE_LEN - BI.READ_LEN + 1, size=n)
        codes = bb[fam[:, None], st[:, None] + np.arange(BI.READ_LEN)[None, :]]
        codes = np.where(rng.random(codes.shape) < 0.01,
                         rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)
        rc = rng.random(n) < 0.5
        codes[rc] = seqmod.revcomp_codes(codes[rc])
        WIDE.update(index=index, codes=codes, lens=np.full(n, BI.READ_LEN, np.int32),
                    times={"library_s": t_lib, "index_s": t_index, "tables_s": t_tables})
    return WIDE


def _wide_engine(chunk, scan):
    from nimble_tpu.config import Config

    w = _wide()
    return E.AlignEngine(w["index"], Config(), chunk_size=chunk, max_len=100,
                         scan_chunks=scan)


@section
def wide():
    w = _wide()
    res = dict(w["times"])
    res["step"] = _step("wide_c65536_s8", _wide_engine(65536 // DIV, 8),
                        w["codes"], w["lens"])
    return res


@section
def sweep():
    out = []
    for wl in ("hla", "wide"):
        for chunk in (16384, 65536, 131072):
            for scan in (1, 8):
                c = chunk // DIV
                if wl == "hla":
                    eng, codes, lens = _hla_engine(c, scan)
                else:
                    eng = _wide_engine(c, scan)
                    codes, lens = _wide()["codes"], _wide()["lens"]
                r = _step(f"sweep_{wl}_c{chunk}_s{scan}", eng, codes, lens, do_trace=False)
                r.update(workload=wl, chunk=chunk, scan=scan)
                r["host_io_reads_per_s"] = _host_io(eng, codes, lens)
                out.append(r)
                del eng
    return out


def main():
    global DIV, OUT, WIDE_LIB
    OUT = pathlib.Path(sys.argv[1])
    OUT.mkdir(parents=True, exist_ok=True)
    names = sys.argv[2].split(",") if len(sys.argv) > 2 and sys.argv[2] else [
        "copy", "window", "band", "mono", "hla", "wide", "sweep"]
    DIV = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    WIDE_LIB = sys.argv[4] if len(sys.argv) > 4 else None
    accel.compile_cache_dir()
    log(accel.device_line())
    if jax.default_backend() == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        log(f"card: {card}")
        RESULTS["card"] = card
    RESULTS["device"] = accel.device_line()
    for name in names:
        globals()[name]()
        (OUT / "stage_profile.json").write_text(json.dumps(RESULTS, indent=1, default=str))


if __name__ == "__main__":
    main()
