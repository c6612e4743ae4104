"""Dissect end-to-end CLI align wall time: reader, pack, dispatch, collect.

Usage: python scripts/ablate_e2e.py LIB FASTQ [N_SPANS] [MODE]
MODE: all (default) | host (reader+pack only) | dispatch (no collect)
"""
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, pathlib.Path(__file__).resolve().parents[1].as_posix())


def main():
    lib, fq = sys.argv[1], sys.argv[2]
    n_spans = int(sys.argv[3]) if len(sys.argv) > 3 else 6
    mode = sys.argv[4] if len(sys.argv) > 4 else "all"

    from nimble_tpu.align.pipeline import (
        SpanFeeder,
        _make_batches,
        make_runner,
    )
    from nimble_tpu import accel
    from nimble_tpu.align.engine import AlignEngine
    from nimble_tpu.io.packing import pack_batch

    accel.compile_cache_dir()
    t0 = time.perf_counter()
    runner = make_runner(lib, "/dev/null", build_engine=False)
    L = 128
    engine = AlignEngine(runner.index, runner.config, chunk_size=None, max_len=L)
    span = engine.scan_chunks * engine.chunk_size
    print(f"engine: chunk={engine.chunk_size} scan={engine.scan_chunks} span={span} "
          f"built in {time.perf_counter()-t0:.1f}s")

    batches, _reader = _make_batches([fq], False, 1 << 17, 256, 4, 2)
    feeder = SpanFeeder(span, False)

    t_read = t_pack = t_submit = t_collect = 0.0
    spans_done = 0
    inflight = []
    total_rows = 0

    def collect_one(h):
        nonlocal t_collect, total_rows
        t = time.perf_counter()
        out = engine.collect_async(h)
        t_collect += time.perf_counter() - t
        return out["pass_"].sum()

    wall0 = time.perf_counter()
    while spans_done < n_spans:
        t = time.perf_counter()
        batch = next(batches, None)
        t_read += time.perf_counter() - t
        if batch is None:
            break
        t = time.perf_counter()
        pb = pack_batch(batch, L)
        t_pack += time.perf_counter() - t
        for sb in feeder.add(pb):
            if mode == "host":
                spans_done += 1
                continue
            t = time.perf_counter()
            h = engine.align_packed_async(sb)
            dt_sub = time.perf_counter() - t
            t_submit += dt_sub
            inflight.append(h)
            dt_col = 0.0
            if len(inflight) > 2 and mode == "all":
                t = time.perf_counter()
                total_rows += collect_one(inflight.pop(0))
                dt_col = time.perf_counter() - t
            spans_done += 1
            print(f"  span {spans_done}: submit {dt_sub:.2f}s collect {dt_col:.2f}s",
                  flush=True)
            if spans_done >= n_spans:
                break
    if mode != "host":
        for h in inflight:
            total_rows += collect_one(h)
    wall = time.perf_counter() - wall0
    n_reads = spans_done * span
    print(f"mode={mode}: {spans_done} spans ({n_reads} reads) in {wall:.2f}s "
          f"-> {n_reads/wall/1e6:.3f}M reads/s")
    print(f"  read   {t_read:7.2f}s")
    print(f"  pack   {t_pack:7.2f}s")
    print(f"  submit {t_submit:7.2f}s")
    print(f"  collect{t_collect:7.2f}s  rows={total_rows}")


if __name__ == "__main__":
    main()
