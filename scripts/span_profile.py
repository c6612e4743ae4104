"""Phase breakdown of one 20k-allele CLI span (VERDICT r5 follow-up): where
does span wall time go — device exec, D2H transfer, compact unpack, band
expansion, class resolution, row formatting? Run after the emit-cap fix to
find the remaining e2e bottleneck."""
import sys, time
sys.path.insert(0, ".")
import numpy as np

def main():
    import jax
    from nimble_tpu import accel

    accel.compile_cache_dir()

    from nimble_tpu.config import Config
    from nimble_tpu.index.builder import KmerIndex
    from nimble_tpu.align.engine import (
        AlignEngine, unpack_outputs_compact, expand_band_rows_np,
    )
    from nimble_tpu.align.pipeline import (
        resolve_features_compact, EmitConfig,
    )
    from nimble_tpu.io.packing import pack_batch
    from nimble_tpu import seq as seqmod

    index = KmerIndex.load(".bench_data/big20k.json.idx.npz")
    config = Config()
    chunk_arg = int(sys.argv[1]) if len(sys.argv) > 1 else None
    max_len_arg = int(sys.argv[2]) if len(sys.argv) > 2 else 112
    t0 = time.time()
    engine = AlignEngine(index, config, chunk_size=chunk_arg, max_len=max_len_arg)
    print(f"engine up in {time.time()-t0:.1f}s chunk={engine.chunk_size} "
          f"S={engine.scan_chunks} banded={engine._banded_wire} "
          f"emit_cap={engine.emit_cap}", file=sys.stderr, flush=True)

    # reads: same distribution as the e2e FASTQ (backbone + 1% error)
    rng = np.random.default_rng(0)
    backbones = []
    for fam in range(20):
        backbones.append(rng.integers(0, 4, size=3000).astype(np.int8))
        for _ in range(1000):  # burn the library's per-allele SNP draws
            rng.integers(0, 3000, size=25)
            rng.integers(0, 4, size=25)
    rng = np.random.default_rng(7)
    span = engine.scan_chunks * engine.chunk_size
    fam = rng.integers(0, 20, size=span)
    st = rng.integers(0, 3000 - 100 + 1, size=span)
    bb = np.stack(backbones)
    idx2 = st[:, None] + np.arange(100)[None, :]
    codes = bb[fam[:, None], idx2].astype(np.int8)
    err = rng.random((span, 100)) < 0.01
    codes = np.where(err, rng.integers(0, 4, size=codes.shape), codes).astype(np.int8)
    rc = rng.random(span) < 0.5
    codes[rc] = seqmod.revcomp_codes(codes[rc])
    lens = np.full(span, 100, dtype=np.int32)

    t0 = time.time()
    pb = pack_batch({"r1_codes": codes, "r1_lens": lens}, max_len_arg)
    print(f"pack: {time.time()-t0:.2f}s", flush=True)

    # compile + settle
    pend = engine.align_packed_async(pb)
    engine.collect_async(pend)

    from nimble_tpu.align.pipeline import (
        resolve_features_band, resolve_features_ids,
    )
    from nimble_tpu.io import native

    for trial in range(3):
        t0 = time.time()
        pend = engine.align_packed_async(pb)
        flat = pend[0][0]
        jax.block_until_ready(flat)
        t_exec = time.time() - t0
        mb = flat.size * 4 / 1e6

        t0 = time.time()
        out = engine.collect_async(pend, expand_band=False)
        t_collect = time.time() - t0

        emit = EmitConfig(group_on=False, discard_multiple_matches=False,
                          discard_multi_hits=0, max_hits_to_report=10)
        t0 = time.time()
        if out.get("ids") is not None:
            u_features, u_keep, inverse = resolve_features_ids(
                index, out["ids"], emit
            )
        elif out.get("band_rows") is not None:
            u_features, u_keep, inverse = resolve_features_band(
                index, out["band_rows"], out["band_meta"][0], emit
            )
        else:
            u_features, u_keep, inverse = resolve_features_compact(
                index, out["bits"], emit
            )
        t_resolve = time.time() - t0

        keep = u_keep[inverse] & out["pass_"].astype(bool)
        t0 = time.time()
        if native.available():
            native.format_rows(
                inverse, keep, u_features, out["score"],
                out["r1_fwd"], out["r2_fwd"],
            )
        t_fmt = time.time() - t0

        total = t_exec + t_collect + t_resolve + t_fmt
        print(
            f"trial{trial}: exec+queue {t_exec:.2f}s | collect(D2H+unpack) "
            f"{t_collect:.2f}s ({mb:.0f} MB) | resolve {t_resolve:.2f}s | "
            f"format {t_fmt:.2f}s | sum {total:.2f}s -> "
            f"{span/total/1e3:.0f}k reads/s; kept {int(keep.sum())}",
            flush=True,
        )


if __name__ == "__main__":
    main()
