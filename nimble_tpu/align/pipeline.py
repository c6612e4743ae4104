"""Host-side alignment pipeline: read streaming, emission, multi-library.

Orchestrates the device engine over streamed read batches and emits the
alignment-results TSV in the reference backend's schema (reference consumers:
nimble/__main__.py:237-241, nimble/report_generation.py:275-288). Set-size
filters (discard_multiple_matches / discard_multi_hits / max_hits_to_report)
and group_on collapse run here on decoded feature sets — O(aligned reads),
off the device hot path.

Multi-library alignment happens in a single pass over the reads: each batch
is aligned against every library's engine before the next batch is read
(reference: -r/-o pairs, __main__.py:182-189).
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nimble_tpu.align.engine import AlignEngine
from nimble_tpu.config import Config, load_library
from nimble_tpu.index.builder import KmerIndex, build_index_for_library

TSV_HEADER = [
    "nimble_features",
    "nimble_score",
    "r1_CB",
    "r1_UB",
    "r2_CB",
    "r2_UB",
    "r1_POS",
    "r2_POS",
    "r1_forward_score",
    "r2_forward_score",
    "r1_GN",
]


def decode_bitsets(bits: np.ndarray, n_features: int) -> np.ndarray:
    """(B, W) uint32 bitsets -> (B, n_features) bool membership matrix."""
    if bits.size == 0:
        return np.zeros((bits.shape[0], n_features), dtype=bool)
    u8 = bits.astype("<u4", copy=False).view(np.uint8).reshape(bits.shape[0], -1)
    expanded = np.unpackbits(u8, axis=1, bitorder="little")
    return expanded[:, :n_features].astype(bool)


@dataclass
class EmitConfig:
    """Host emission parameters derived from the library Config."""

    group_on: bool
    discard_multiple_matches: bool
    discard_multi_hits: int
    max_hits_to_report: int


def _unique_rows(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(uniq_rows, inverse) like np.unique(bits, axis=0) but ~20x faster.

    np.unique(axis=0) lexsorts W columns (~1s at 524k x 4, squarely on the
    emission critical path). Hashing each row to one
    int64 and uniquing scalars is near-linear. Exactness is verified by
    comparing every row against its representative; a 64-bit collision
    (probability ~n^2/2^64) falls back to the exact path. Unique rows come
    out in hash order, not lexicographic — callers never rely on order.
    """
    n, W = bits.shape
    if n == 0:
        return bits, np.zeros(0, dtype=np.int64)
    mult = np.random.default_rng(0xC0FFEE).integers(
        1, 1 << 62, size=W, dtype=np.int64
    ) | 1
    # blockwise in-place hashing: the one-shot (n, W) int64 temporary is
    # 10x slower at wide W (1.3 GB at 262k x 625 — measured 6.7s vs 0.6s)
    h = np.empty(n, dtype=np.int64)
    with np.errstate(over="ignore"):
        for s in range(0, n, 8192):
            blk = bits[s : s + 8192].astype(np.int64)
            blk *= mult[None, :]
            h[s : s + 8192] = blk.sum(axis=1)
    _, first, inverse = np.unique(h, return_index=True, return_inverse=True)
    uniq = bits[first]
    if not np.array_equal(uniq[inverse], bits):  # hash collision
        return np.unique(bits, axis=0, return_inverse=True)
    return uniq, inverse


def resolve_features_band(
    index: KmerIndex, band_rows: np.ndarray, Pw: int, emit: EmitConfig
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """resolve_features_compact over the banded wire representation
    WITHOUT expanding to dense W-word bitsets.

    The banded codec ships each read's class as [page | 2*Pw band words]
    (engine.compress_band_rows, exact by construction), so uniquing and
    set-bit extraction run on (n, 1+2Pw) rows instead of (n, W): at 20k
    features (W=625) the dense path's unique+decode+nonzero cost 17-22 s
    per 262k-read span — 87% of e2e wall (scripts/span_profile.py, round
    5); this path does the same work in well under a second. Feature id =
    page*Pw*32 + bit position within the band (little-endian word order,
    identical to decode_bitsets)."""
    uniq, inverse = _unique_rows(band_rows)
    u = uniq.shape[0]
    # set-bit positions straight off the narrow band rows
    u8 = np.ascontiguousarray(uniq[:, 1:], dtype="<i4").view(np.uint8)
    expanded = np.unpackbits(u8.reshape(u, -1), axis=1, bitorder="little")
    rows, bitpos = np.nonzero(expanded)
    cols = (uniq[rows, 0].astype(np.int64) * (Pw * 32) + bitpos).astype(
        np.int32
    )
    tail = cols >= index.n_features  # last-word padding bits, if any
    if tail.any():
        rows, cols = rows[~tail], cols[~tail]
    return _resolve_classes_from_cols(index, u, rows, cols, emit, inverse)


def resolve_features_ids(
    index: KmerIndex, ids: np.ndarray, emit: EmitConfig
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """resolve_features_compact over the idlist wire: (n, cap) per-read
    feature-id rows, -1 padded (engine.pack_outputs_idlist). No bitset
    decode at all — unique the id rows, then feed (rows, cols) straight
    to the shared class resolver."""
    uniq, inverse = _unique_rows(ids)
    u = uniq.shape[0]
    present = (uniq >= 0) & (uniq < index.n_features)  # guard stray ids
    rows, _ = np.nonzero(present)
    cols = uniq[present].astype(np.int32)
    return _resolve_classes_from_cols(index, u, rows, cols, emit, inverse)


def resolve_features_compact(
    index: KmerIndex, bits: np.ndarray, emit: EmitConfig
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Decode device bitsets into per-ambiguity-class feature strings.

    Applies group_on collapse then the set-size filters. Returns
    (feature_string per unique class, keep mask per unique class, inverse
    map read -> class), so downstream emission materializes each class
    string once, not once per read.
    """
    uniq, inverse = _unique_rows(bits)
    member = decode_bitsets(uniq, index.n_features)
    rows, cols = np.nonzero(member)
    u = member.shape[0]
    return _resolve_classes_from_cols(index, u, rows, cols, emit, inverse)


def _resolve_classes_from_cols(
    index: KmerIndex, u: int, rows: np.ndarray, cols: np.ndarray,
    emit: EmitConfig, inverse: np.ndarray,
):
    """Shared tail of the three feature resolvers: group_on collapse,
    set-size filters, name pooling — native (nt_resolve_classes) or the
    python fallback. rows must be sorted (row-major nonzero order); cols
    are feature ids already bounded by n_features."""
    if emit.group_on:
        cols = index.feature_to_group[cols]
        names = index.group_names
    else:
        names = index.feature_names
    boundaries = np.searchsorted(rows, np.arange(u + 1))

    from nimble_tpu.io import native

    if native.available():
        lexrank, names_bytes, name_offs = _lex_tables(index, emit.group_on, names)
        u_keep, pool, pool_offs = native.resolve_classes(
            boundaries,
            cols,
            lexrank,
            names_bytes,
            name_offs,
            emit.discard_multiple_matches,
            emit.discard_multi_hits,
            emit.max_hits_to_report,
        )
        return (pool, pool_offs), u_keep, inverse

    u_features: List[str] = [""] * u
    u_keep = np.zeros(u, dtype=bool)
    for i in range(u):
        s, e = boundaries[i], boundaries[i + 1]
        if s == e:
            continue
        ids = np.unique(cols[s:e])
        if emit.discard_multiple_matches and ids.size > 1:
            continue
        if emit.discard_multi_hits > 0 and ids.size > emit.discard_multi_hits:
            continue
        if ids.size > emit.max_hits_to_report:
            continue
        u_features[i] = ",".join(sorted(names[g] for g in ids))
        u_keep[i] = True

    return u_features, u_keep, inverse


def _lex_tables(index: KmerIndex, group_on: bool, names):
    """Cached per-index lex-order tables for native class resolution:
    (lexrank: id -> lex position, concatenated lex-ordered name bytes,
    offsets). Sorting is by the same Python str ordering the fallback's
    sorted() uses."""
    cache = getattr(index, "_lex_cache", None)
    if cache is None:
        cache = {}
        index._lex_cache = cache
    got = cache.get(group_on)
    if got is None:
        order = sorted(range(len(names)), key=lambda i: names[i])
        lexrank = np.empty(len(names), dtype=np.int32)
        for r, i in enumerate(order):
            lexrank[i] = r
        pool = [names[i].encode() for i in order]
        name_offs = np.zeros(len(pool) + 1, dtype=np.int64)
        if pool:
            np.cumsum([len(b) for b in pool], out=name_offs[1:])
        got = (lexrank, b"".join(pool), name_offs)
        cache[group_on] = got
    return got


def _feature_str(u_features, j: int) -> str:
    """Index the resolve_features_compact string pool (list or
    (bytes, offsets) tuple) as str."""
    if isinstance(u_features, tuple):
        pool, offs = u_features
        return pool[offs[j] : offs[j + 1]].decode()
    return u_features[j]


def resolve_features(
    index: KmerIndex, bits: np.ndarray, emit: EmitConfig
) -> Tuple[List[str], np.ndarray]:
    """Per-read view of resolve_features_compact: (feature_string per read,
    keep mask per read); dropped reads get ''."""
    u_features, u_keep, inverse = resolve_features_compact(index, bits, emit)
    return [_feature_str(u_features, j) for j in inverse], u_keep[inverse]


def trimmed_lens(lens: np.ndarray, trim: Tuple[int, float]) -> np.ndarray:
    """Read trimming [inferred semantics]: the reference exposes
    trim_target_length/trim_strictness in the library Config plus a --trim
    "<TARGET>:<STRICTNESS>" override (reference: nimble/types.py:24-25,
    __main__.py:191-192,400); the backend's exact rule is not recoverable
    from the frontend. The rule implemented here: strictness is how strictly
    the target length is enforced — a read's 3' overhang beyond the target
    is cut by round(strictness * overhang) bases, so strictness 1.0 is a
    hard cap at target_length, 0.0 disables trimming, and intermediate
    values trim proportionally."""
    target, strictness = trim
    if target <= 0 or strictness <= 0:
        return lens
    overhang = np.maximum(lens - target, 0)
    cut = np.rint(strictness * overhang).astype(lens.dtype)
    return lens - cut


@dataclass
class LibraryRunner:
    """One library's engine + emission state + output file.

    engine is None while undecided: in stacked multi-library mode the
    per-library engines (and their HBM-resident device tables) are never
    constructed — the StackedEngine answers every library from one probe."""

    config: Config
    index: KmerIndex
    engine: Optional[AlignEngine]
    emit: EmitConfig
    output_path: str
    trim: Tuple[int, float] = (0, 0.0)  # (target_length, strictness); (0, _) = off
    final_path: str = ""  # multi-process runs: merged destination (output_path
    # then points at this process's headerless shard file)
    _file: object = None
    rows_written: int = 0

    def open(self, header: bool = True):
        self._file = open(self.output_path, "wb")
        if header:
            self._file.write(("\t".join(TSV_HEADER) + "\n").encode())

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def submit_batch(self, batch: Dict[str, np.ndarray]):
        """Dispatch one batch to the device without waiting; returns a
        handle for finalize_batch. Host emission of batch N overlaps the
        device aligning batch N+1 (JAX async dispatch)."""
        r1_lens = trimmed_lens(batch["r1_lens"], self.trim)
        r2_lens = batch.get("r2_lens")
        if r2_lens is not None:
            r2_lens = trimmed_lens(r2_lens, self.trim)
        out = self.engine.align_batch_async(
            batch["r1_codes"],
            r1_lens,
            batch.get("r2_codes"),
            r2_lens,
        )
        return (out, batch)

    def finalize_batch(self, handle) -> int:
        """Transfer device outputs and append passing rows to the TSV."""
        pending, batch = handle
        out = self.engine.collect_async(pending)
        return self.emit_out(out, batch)

    def emit_out(self, out, batch) -> int:
        """Append this library's passing rows from host-numpy outputs.

        The hot path formats rows in C++ (io.native.format_rows, >50M
        rows/s); the Python f-string loop below is the fallback when the
        native library is unavailable (it capped the whole CLI at ~0.6M
        rows/s on the emission critical path)."""
        if out is None:
            return 0
        pass_ = out["pass_"]
        if out.get("ids") is not None:
            u_features, u_keep, inverse = resolve_features_ids(
                self.index, out["ids"], self.emit
            )
        elif out.get("band_rows") is not None:
            u_features, u_keep, inverse = resolve_features_band(
                self.index, out["band_rows"], out["band_meta"][0], self.emit
            )
        else:
            u_features, u_keep, inverse = resolve_features_compact(
                self.index, out["bits"], self.emit
            )
        keep = u_keep[inverse] & pass_
        n_kept = int(np.count_nonzero(keep))
        if n_kept == 0:
            return 0
        cbs = batch.get("cbs")
        umis = batch.get("umis")
        poss = batch.get("poss")
        gns = batch.get("gns")
        score = out["score"]
        f1 = out["r1_fwd"]
        f2 = out["r2_fwd"]

        from nimble_tpu.io import native

        if native.available():
            pos_arr = (
                np.asarray(poss, dtype=np.int32) if poss is not None else None
            )
            buf = native.format_rows(
                inverse,
                keep,
                u_features,
                score,
                f1,
                f2,
                cbs=cbs,
                umis=umis,
                gns=gns,
                pos1=pos_arr[:, 0] if pos_arr is not None else None,
                pos2=pos_arr[:, 1] if pos_arr is not None else None,
            )
            self._file.write(buf)
            self.rows_written += n_kept
            return n_kept

        idxs = np.nonzero(keep)[0]
        lines = []
        for i in idxs:
            cb = cbs[i] if cbs is not None else ""
            umi = umis[i] if umis is not None else ""
            pos1, pos2 = poss[i] if poss is not None else ("", "")
            gn = gns[i] if gns is not None else ""
            lines.append(
                f"{u_features[inverse[i]]}\t{score[i]}\t{cb}\t{umi}\t{cb}\t{umi}\t"
                f"{pos1}\t{pos2}\t{f1[i]}\t{f2[i]}\t{gn}\n"
            )
        self._file.write("".join(lines).encode())
        self.rows_written += len(lines)
        return len(lines)


def make_runner(
    library_path: str,
    output_path: str,
    strand_filter: str = "unstranded",
    paired: bool = False,
    chunk_size: Optional[int] = 2048,
    max_len: int = 256,
    kmer_length: Optional[int] = None,
    mesh=None,
    build_engine: bool = True,
    group_g: Optional[int] = None,
) -> LibraryRunner:
    config, data = load_library(library_path)
    index = build_index_for_library(
        library_path, data, config, k=kmer_length, group_g=group_g
    )
    engine = None
    if build_engine:
        engine = AlignEngine(
            index,
            config,
            strand_filter=strand_filter,
            chunk_size=chunk_size,
            max_len=max_len,
            paired=paired,
            mesh=mesh,
        )
    emit = EmitConfig(
        group_on=bool(config.group_on),
        discard_multiple_matches=bool(config.discard_multiple_matches),
        discard_multi_hits=int(config.discard_multi_hits),
        max_hits_to_report=int(config.max_hits_to_report),
    )
    return LibraryRunner(config, index, engine, emit, output_path)


def _round_len(n: int, minimum: int = 32) -> int:
    """Round a read length up to a multiple of 16 (one packed int32 word;
    stable packed widths and compile-cache keys across batches)."""
    return max(minimum, -(-int(n) // 16) * 16)


class SpanFeeder:
    """Accumulates read batches and carves exact dispatch spans.

    Decouples the reader's batch size from the engine's dispatch span
    (scan_chunks * chunk_size): every dispatch except the last is a
    full span, so no padding waste, regardless of reader batching. Handles
    both the packed wire format (r1_words + sparse N sidecar) and int8
    codes batches; per-read metadata (cbs/umis/poss/gns/names) rides along.

    The sparse N sidecar needs join-aware handling: `<mate>_nidx` holds
    row indices into the batch and `<mate>_nrows` the flag rows at those
    indices — merges offset the indices, slices rebase them.

    Skip markers: a batch may arrive as `{"skip": n}` — n records whose
    bytes the reader never parsed because every span they touch belongs to
    another process (multi-process decode sharding; io/threaded.py
    set_skip). Any carved span containing skipped records is emitted as
    `{"skip": span_count}` (real boundary reads inside it are discarded —
    by the skip predicate's construction such a span is never owned by
    this process), so downstream span indexing and read cursors stay
    exactly aligned with a full-decode run."""

    def __init__(self, span: int, paired: bool):
        self.span = span
        self.paired = paired
        self.parts: List[dict] = []
        self.count = 0

    @staticmethod
    def _part_n(p: dict) -> int:
        return p["skip"] if "skip" in p else p["r1_lens"].shape[0]

    def add(self, pb: dict) -> List[dict]:
        self.parts.append(pb)
        self.count += self._part_n(pb)
        out = []
        while self.count >= self.span:
            out.append(self._take(self.span))
        return out

    def _take(self, want: int) -> dict:
        """Consume exactly `want` records from the head of parts."""
        taken: List[dict] = []
        need = want
        while need:
            p = self.parts[0]
            n = self._part_n(p)
            if n <= need:
                taken.append(self.parts.pop(0))
                need -= n
            else:
                if "skip" in p:
                    taken.append({"skip": need})
                    self.parts[0] = {"skip": n - need}
                else:
                    taken.append(self._slice(p, 0, need))
                    self.parts[0] = self._slice(p, need, n)
                need = 0
        self.count -= want
        if any("skip" in p for p in taken):
            return {"skip": want}
        save, self.parts = self.parts, taken
        try:
            return self._merge()
        finally:
            self.parts = save

    def flush(self) -> Optional[dict]:
        if self.count == 0:
            return None
        out = self._take(self.count)
        self.parts = []
        return out

    def repack_width(self, Lw: int, Lf: int):
        """Zero-pad buffered packed arrays to wider word counts (after a
        max-read-length rebuild; packing is per-read, padding is zeros)."""
        for pb in self.parts:
            for mate in ("r1", "r2") if self.paired else ("r1",):
                w = pb.get(f"{mate}_words")
                if w is not None and w.shape[1] < Lw:
                    pb[f"{mate}_words"] = np.pad(w, ((0, 0), (0, Lw - w.shape[1])))
                r = pb.get(f"{mate}_nrows")
                if r is not None and r.shape[1] < Lf:
                    pb[f"{mate}_nrows"] = np.pad(r, ((0, 0), (0, Lf - r.shape[1])))

    def _merge(self) -> dict:
        if len(self.parts) == 1:
            return self.parts[0]
        out: dict = {}
        p0 = self.parts[0]
        offs = np.cumsum([0] + [p["r1_lens"].shape[0] for p in self.parts])
        for k, v in p0.items():
            if k.endswith("_nidx"):
                out[k] = np.concatenate(
                    [p[k] + o for p, o in zip(self.parts, offs)]
                ).astype(np.int32)
            elif isinstance(v, np.ndarray):
                out[k] = np.concatenate([p[k] for p in self.parts])
            elif isinstance(v, list):
                out[k] = [x for p in self.parts for x in p[k]]
            else:
                out[k] = v
        return out

    def _slice(self, pb: dict, start: int, end: int) -> dict:
        out: dict = {}
        for k, v in pb.items():
            if k.endswith("_nidx"):
                lo = int(np.searchsorted(v, start))
                hi = int(np.searchsorted(v, end))
                out[k] = (v[lo:hi] - start).astype(np.int32)
                out[k[:-5] + "_nrows"] = pb[k[:-5] + "_nrows"][lo:hi]
            elif k.endswith("_nrows"):
                pass  # handled with its _nidx
            elif isinstance(v, (np.ndarray, list)):
                out[k] = v[start:end]
            else:
                out[k] = v
        return out


def append_path_string(input_path: str, append: str) -> str:
    """Insert a suffix before the (full, possibly multi-part) extension
    (reference: utils.py:9-27)."""
    filename = os.path.basename(input_path)
    root = filename
    ext = ""
    while True:
        root, ext2 = os.path.splitext(root)
        if ext2 == "":
            break
        ext = ext2 + ext
    return os.path.join(os.path.dirname(input_path), root + append + ext)


def _prefetch_iter(gen, depth: int = 3):
    """Drain `gen` on a daemon producer thread through a bounded queue.
    Exceptions re-raise at the consumer; the bound is the backpressure.
    An abandoned consumer (error mid-run, generator close) sets a stop
    flag so the producer exits and `gen`'s finally (reader close) runs
    instead of blocking forever on a full queue."""
    import queue as _q
    import threading as _t

    q = _q.Queue(maxsize=depth)
    sentinel = object()
    stop = _t.Event()
    err: List[BaseException] = []

    def run():
        try:
            for item in gen:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except _q.Full:
                        continue
                if stop.is_set():
                    break
        except BaseException as e:  # surfaced at the consumer
            err.append(e)
        finally:
            gen.close() if hasattr(gen, "close") else None
            try:
                q.put_nowait(sentinel)
            except _q.Full:
                pass

    _t.Thread(target=run, daemon=True, name="bam-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def _make_batches(
    inputs: Sequence[str],
    is_bam: bool,
    batch_records: int,
    max_len: int,
    num_cores: int,
    inflight_batches: int,
):
    """(batch iterator, reader object or None). Batches are dicts
    (r1_codes/r1_lens[, r2_*][, meta]); the reader object is returned for
    readers that support decode sharding (ThreadedFastqReader.set_skip)."""
    if is_bam:
        from nimble_tpu.io import native

        # non-regular inputs (FIFOs, process substitution) go to the pure
        # python reader: the native open probes the first bytes for the
        # BGZF signature and its plain-gzip fallback reopens the path —
        # both only sound on seekable regular files
        if native.available() and os.path.isfile(inputs[0]):
            # producer-thread prefetch: nt_bam_read_batch runs inside a
            # ctypes call (GIL released), so BGZF inflate + record parse
            # overlap the main loop's dispatch/emission Python work —
            # the paired e2e was reader-bound without this
            return (
                _prefetch_iter(
                    native.iter_native_bam_batches(
                        inputs[0], batch_records=batch_records,
                        max_len=max_len,
                    ),
                    depth=max(2, inflight_batches + 1),
                ),
                None,
            )
        from nimble_tpu.io.bam import iter_bam_batches

        return (
            iter_bam_batches(
                inputs[0], batch_records=batch_records, max_len=max_len
            ),
            None,
        )
    from nimble_tpu.io import native

    if num_cores > 1 and native.available():
        # threaded host decode: a producer thread inflates + cuts the
        # stream, num_cores native parse workers 2-bit-encode chunks
        # in parallel (the GIL is released inside the ctypes call),
        # matching the reference's `-c` whole-hot-path threading
        # (reference: __main__.py:180)
        from nimble_tpu.io.threaded import ThreadedFastqReader

        reader = ThreadedFastqReader(
            inputs[0],
            inputs[1] if len(inputs) == 2 else None,
            batch_size=batch_records,
            max_len=max_len,
            num_threads=num_cores,
            prefetch=max(2, inflight_batches + 1),
        )
        return iter(reader), reader
    if native.available():
        from nimble_tpu.io.native import NativeFastqReader

        return (
            iter(
                NativeFastqReader(
                    inputs[0],
                    inputs[1] if len(inputs) == 2 else None,
                    batch_size=batch_records,
                    max_len=max_len,
                )
            ),
            None,
        )
    from nimble_tpu.io.fastq import FastqReader

    return (
        iter(
            FastqReader(
                inputs[0],
                inputs[1] if len(inputs) == 2 else None,
                batch_size=batch_records,
                max_len=max_len,
            )
        ),
        None,
    )


def _slice_reader_batch(batch: dict, start: int) -> dict:
    """Tail [start:] of a reader batch dict (arrays and metadata lists)."""
    out = {}
    for k, v in batch.items():
        out[k] = v[start:] if v is not None else None
    return out


def _build_engines(
    runners: List[LibraryRunner],
    strand_filter: str,
    chunk_size: Optional[int],
    max_len: int,
    paired: bool,
    mesh_plan,
    chunk_cap: Optional[int],
    log,
):
    """(Re)construct the device engines at a given max read length.

    Stacked multi-library mode: when every library shares k/stride (and
    trim), ONE device probe per window answers all of them (align/stacked
    .py); otherwise each library keeps its standalone engine. A
    feature-split mesh is incompatible with stacking (bits are inlined in
    the stacked bucket rows), so it routes to per-library engines.
    Returns the StackedEngine or None (per-library engines on runners)."""
    stacked = None
    if (
        len(runners) > 1
        and len({r.trim for r in runners}) == 1
        and (mesh_plan is None or mesh_plan.n_feature == 1)
        and os.environ.get("NIMBLE_TPU_NO_STACK", "") != "1"
    ):
        from nimble_tpu.align.stacked import StackedEngine

        if StackedEngine.compatible(
            [r.index for r in runners], [r.config for r in runners]
        ):
            try:
                stacked = StackedEngine(
                    [r.index for r in runners],
                    [r.config for r in runners],
                    strand_filter=strand_filter,
                    chunk_size=chunk_size,
                    max_len=max_len,
                    paired=paired,
                    mesh=mesh_plan,
                    chunk_cap=chunk_cap,
                )
                log.event(
                    "stacked_engine",
                    n_libraries=len(runners),
                    group_g=stacked.group_g,
                    max_len=max_len,
                )
            except ValueError:
                stacked = None
    if stacked is None:
        with log.stage("engine_build", max_len=max_len):
            for r in runners:
                r.engine = AlignEngine(
                    r.index,
                    r.config,
                    strand_filter=strand_filter,
                    chunk_size=chunk_size,
                    max_len=max_len,
                    paired=paired,
                    mesh=mesh_plan,
                    chunk_cap=chunk_cap,
                )
                log.event(
                    "engine",
                    path=r.engine.probe_path,
                    wire=r.engine.wire,
                    chunk=r.engine.chunk_size,
                    scan_chunks=r.engine.scan_chunks,
                )
    return stacked


def _align_world() -> Tuple[int, int]:
    """Multi-process placement for `align` (process_id, num_processes).

    Env-gated: JAX_COORDINATOR_ADDRESS initializes jax.distributed (real
    multi-host pods; parallel/dist.init_distributed), after which the JAX
    process grid is authoritative. Without a coordinator, the
    NIMBLE_TPU_NUM_PROCS / NIMBLE_TPU_PROC_ID pair drives independent
    processes (CPU-mesh tests, manual multi-host launches over a shared
    filesystem); on a GPU host each takes card NIMBLE_TPU_PROC_ID alone
    (accel.claim_card, before JAX starts its backends). Default: single
    process.
    """
    from nimble_tpu.parallel.dist import init_distributed

    if init_distributed():
        import jax

        return jax.process_index(), jax.process_count()
    n = int(os.environ.get("NIMBLE_TPU_NUM_PROCS", "1") or 1)
    if n <= 1:
        return 0, 1
    pid = int(os.environ.get("NIMBLE_TPU_PROC_ID", "0") or 0)
    assert 0 <= pid < n, f"NIMBLE_TPU_PROC_ID {pid} out of range for {n} procs"
    from nimble_tpu import accel

    accel.claim_card(pid, n)
    return pid, n


def _write_shard_meta(output: str, pid: int, span_meta, total: int) -> None:
    """Persist this shard's span-order byte accounting, then the `.done`
    sentinel (the merge barrier; written LAST so a visible sentinel implies
    a complete meta)."""
    import json as _json

    with open(f"{output}.shard{pid}.meta.json", "w") as f:
        _json.dump({"spans": span_meta, "total": total}, f)
    with open(f"{output}.shard{pid}.done", "w"):
        pass


def _merge_shards(output: str, final_paths: Sequence[str], world_n: int) -> int:
    """Host-0 merge: wait for every shard's `.done` sentinel on the shared
    filesystem, then splice shard files back into reader order.

    Each process owns spans round-robin by span index and its shard file
    holds its spans' rows contiguously in ascending index order, so the
    merged file — header + span byte-ranges in global index order — is
    byte-identical to a single-process run. Returns the merged read total.
    """
    import json as _json
    import time as _time

    timeout = float(os.environ.get("NIMBLE_TPU_MERGE_TIMEOUT_S", "3600"))
    deadline = _time.monotonic() + timeout
    for p in range(world_n):
        sentinel = f"{output}.shard{p}.done"
        while not os.path.exists(sentinel):
            if _time.monotonic() > deadline:
                raise TimeoutError(f"merge barrier: {sentinel} never appeared")
            _time.sleep(0.2)

    metas = []
    for p in range(world_n):
        with open(f"{output}.shard{p}.meta.json") as f:
            metas.append(_json.load(f))
    total = sum(m["total"] for m in metas)

    # (span_idx, owner, bytes_by_final_path), globally ordered
    schedule = sorted(
        (idx, p, by_lib)
        for p, m in enumerate(metas)
        for idx, by_lib in m["spans"]
    )
    for fp in final_paths:
        shard_files = [open(f"{fp}.shard{p}", "rb") for p in range(world_n)]
        try:
            with open(fp, "wb") as out:
                out.write(("\t".join(TSV_HEADER) + "\n").encode())
                for _idx, p, by_lib in schedule:
                    nbytes = by_lib.get(fp, 0)
                    if nbytes:
                        out.write(shard_files[p].read(nbytes))
        finally:
            for f in shard_files:
                f.close()
        for p in range(world_n):
            os.remove(f"{fp}.shard{p}")
    for p in range(world_n):
        os.remove(f"{output}.shard{p}.meta.json")
        os.remove(f"{output}.shard{p}.done")
    return total


def align_files(
    reference: str,
    output: str,
    inputs: Sequence[str],
    strand_filter: str = "unstranded",
    chunk_size: Optional[int] = None,
    max_len: int = 0,
    batch_records: Optional[int] = None,
    resume: bool = False,
    trim: str = "",
    mesh: str = "",
    num_cores: int = 1,
    inflight_batches: int = 2,
    probe: str = "group",
) -> int:
    """The `align` subcommand: 1-2 FASTQs or 1 BAM vs comma-separated
    library list, one output TSV per library (reference: __main__.py:153-211).
    Returns a process exit code (nonzero on reader/engine failure, like the
    reference's propagated aligner exit code, reference __main__.py:439-440).

    max_len <= 0 (the default) auto-sizes the packed read width from the
    first batch's longest read (rounded up to a multiple of 32, capped at
    256; longer reads later in the stream trigger a transparent engine
    rebuild at the wider size). An explicit max_len is used as-is and also
    caps/truncates reads at the reader, matching earlier behavior.

    Reads travel host->device in the 2-bit packed wire format
    (io/packing.py), a quarter of the bytes of int8 codes. Mesh runs
    dispatch the packed wire too, sharded over the data axis (words/flags
    on the batch axis, lens on the data axis; dense N flags instead of the
    sparse sidecar).
    NIMBLE_TPU_NO_PACKED=1 forces int8 everywhere.

    num_cores drives host-side decode parallelism (io/threaded.py): a
    producer thread inflates + cuts the FASTQ stream and num_cores native
    parse workers 2-bit-encode record chunks in parallel, feeding a bounded
    prefetch queue; `inflight_batches` spans are kept dispatched to the
    device so host IO, device compute, and host emission all overlap.

    mesh: multi-chip spec "data=N[,feature=M]" (or "auto" for all devices
    on the data axis) — the reference's only parallelism knob is `-c`
    threads (reference: __main__.py:180); here the read stream shards over
    the mesh's data axis and, for feature-split meshes, the class-bitset
    matrix over the feature axis (parallel/mesh.py).

    Checkpoint/resume: a `<output>.progress.json` sidecar records the read
    cursor and per-library row counts/byte offsets after every dispatched
    span (the reference's only resume support is a BAM-sort `.done`
    sentinel; reference: __main__.py:330-333). With resume=True an
    interrupted run fast-forwards the reader, truncates any partial tail
    rows by byte offset, and continues appending.

    Multi-host/multi-process (_align_world; the reference is strictly
    single-host, SURVEY §5.8): with JAX_COORDINATOR_ADDRESS set (real pods,
    jax.distributed) or NIMBLE_TPU_NUM_PROCS/NIMBLE_TPU_PROC_ID exported,
    each process aligns the dispatch spans it owns (round-robin by span
    index) into a headerless `<output>.shardP` file and process 0 splices
    the shards back into reader order over the shared filesystem
    (_merge_shards), producing output byte-identical to a single-process
    run. Device compute, TSV emission, and (with -c, via the threaded
    reader's skip predicate) parse/encode/pack decode all scale with the
    process count; inflate + newline cutting still run per process
    (single-member gzip is not seekable). Resume works per process: each
    shard checkpoints its own cursor + span byte accounting
    (`<output>.shardP.progress.json`, atomic replace) and a killed process
    fast-forwards, truncates its shard at the recorded offset, and
    continues; other shards are unaffected.
    """
    from nimble_tpu import accel
    from nimble_tpu.observability import Throughput, profile, runlog

    accel.compile_cache_dir()
    if probe not in ("", "group", "mono"):
        raise ValueError(f"--probe must be 'group' or 'mono', got {probe!r}")
    # probe path selection (`align --probe`): "group" (default) probes one
    # (k+g-1)-mer per g read windows — faster and, by the recorded A/B
    # (scripts/ab_group_accuracy.py), more accurate under sequencing
    # error, but its per-window hit pattern on errored reads can differ
    # from per-k-mer probing. "mono" probes every k-window individually, the
    # reference-faithful contract. Threaded as group_g into the index build
    # (0 = no group entries -> the engine selects the mono path).
    group_g = 0 if probe == "mono" else None
    log = runlog()
    world_pid, world_n = _align_world()
    if world_n > 1:
        log.event("world", pid=world_pid, n=world_n)
    accel.print_device_line()
    library_list = reference.split(",")
    input_ext = os.path.splitext(inputs[0])[-1].lower()
    is_bam = input_ext == ".bam"
    paired = (len(inputs) == 2) or is_bam

    auto_len = max_len <= 0
    reader_len = max_len if not auto_len else 256

    # per-library trim overrides: "<TARGET_LENGTH>:<STRICTNESS>,..." in
    # library order (reference: __main__.py:191-192,400). A missing
    # strictness means a hard cap (strictness 1.0); without --trim, each
    # library's own Config trim settings apply when the user edited them
    # (Config.trim_spec; rule: pipeline.trimmed_lens).
    trim_targets = {}
    if trim:
        for i, entry in enumerate(trim.split(",")):
            if not entry:
                continue
            parts = entry.split(":")
            strictness = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
            trim_targets[i] = (int(parts[0]), strictness)

    mesh_plan = None
    if mesh:
        from nimble_tpu.parallel.mesh import parse_mesh_spec

        mesh_plan = parse_mesh_spec(mesh)
        if mesh_plan is not None:
            log.event(
                "mesh",
                n_data=mesh_plan.n_data,
                n_feature=mesh_plan.n_feature,
            )

    runners: List[LibraryRunner] = []
    with log.stage("index_build", libraries=library_list):
        for lib_idx, library in enumerate(library_list):
            out_append = ""
            if len(library_list) > 1:
                out_append = "." + os.path.splitext(os.path.basename(library))[0]
            # engines are constructed after the first batch is seen (auto
            # max_len) and after the stacking decision, so stacked runs
            # never materialize per-library device tables in HBM
            runner = make_runner(
                library,
                append_path_string(output, out_append),
                strand_filter=strand_filter,
                paired=paired,
                chunk_size=chunk_size,
                max_len=reader_len,
                build_engine=False,
                group_g=group_g,
            )
            if lib_idx in trim_targets:
                runner.trim = trim_targets[lib_idx]
            elif runner.config.trim_spec() is not None:
                runner.trim = runner.config.trim_spec()
            runners.append(runner)

    if world_n > 1:
        # each process aligns the spans it owns (round-robin by span index)
        # into a headerless shard file; host 0 splices them back into reader
        # order after the sentinel barrier (_merge_shards)
        for r in runners:
            r.final_path = r.output_path
            r.output_path = f"{r.output_path}.shard{world_pid}"

    use_packed = os.environ.get("NIMBLE_TPU_NO_PACKED", "") != "1"

    # per-process sidecar: multi-process runs checkpoint each shard
    # independently (cursor + span byte accounting + shard file offsets),
    # so a killed process resumes its own spans while the others' shards
    # stand
    progress_path = output + (
        ".progress.json" if world_n == 1 else f".shard{world_pid}.progress.json"
    )
    reads_done = 0
    resumed_total = 0
    resumed_spans: List = []
    if resume and os.path.exists(progress_path):
        import json as _json

        with open(progress_path) as f:
            prog = _json.load(f)
        if "reads_done" not in prog:
            print(
                "progress sidecar predates the packed pipeline; "
                "restart without --resume",
                file=sys.stderr,
            )
            return 1
        reads_done = prog.get("reads_done", 0)
        resumed_total = prog.get("total_done", 0)
        resumed_spans = [
            (idx, by_lib) for idx, by_lib in prog.get("spans", [])
        ]
        for r in runners:
            rows_kept = prog.get("rows_written", {}).get(r.output_path, 0)
            byte_off = prog.get("bytes_written", {}).get(r.output_path)
            if os.path.exists(r.output_path) and byte_off is not None:
                # O(1) truncate at the recorded checkpoint offset
                os.truncate(r.output_path, byte_off)
            r.rows_written = rows_kept
        print(f"Resuming from read {reads_done}")
        for r in runners:
            r._file = open(r.output_path, "ab")
    else:
        for r in runners:
            r.open(header=world_n == 1)

    def save_progress(done_reads, spans=None, total_done=0):
        import json as _json

        offsets = {}
        for r in runners:
            r._file.flush()
            offsets[r.output_path] = r._file.tell()
        payload = {
            "reads_done": done_reads,
            "rows_written": {r.output_path: r.rows_written for r in runners},
            "bytes_written": offsets,
        }
        if world_n > 1:
            payload["spans"] = spans or []
            payload["total_done"] = total_done
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(payload, f)
        os.replace(tmp, progress_path)  # atomic: a kill never corrupts it

    reader_batch = (
        batch_records
        or int(os.environ.get("NIMBLE_TPU_READER_BATCH", "0") or 0)
        or (1 << 17)
    )
    total = resumed_total if world_n > 1 else 0
    tput = Throughput(log)
    failed = False
    stacked = None
    emit_shutdown = None
    try:
        batches, reader_obj = _make_batches(
            inputs, is_bam, reader_batch, reader_len, num_cores, inflight_batches
        )
        # auto max_len: peek the FIRST batch of the file (deterministic
        # across resume) and round its longest read up to a multiple of 32
        first = next(batches, None)
        if first is None:
            for r in runners:
                r.close()
            if os.path.exists(progress_path):
                os.remove(progress_path)
            if world_n > 1:
                _write_shard_meta(output, world_pid, [], 0)
                if world_pid == 0:
                    _merge_shards(output, [r.final_path for r in runners], world_n)
            print(f"Aligned 0 read(-pair)s across {len(runners)} library(ies)")
            return 0
        if auto_len and use_packed:
            m = int(np.max(first["r1_lens"]))
            if paired and first.get("r2_lens") is not None:
                m = max(m, int(np.max(first["r2_lens"])))
            L = min(_round_len(m), reader_len)
        else:
            L = reader_len

        stacked = _build_engines(
            runners, strand_filter, chunk_size, L, paired, mesh_plan,
            batch_records, log,
        )
        eng0 = stacked if stacked is not None else runners[0].engine
        span = eng0.scan_chunks * eng0.chunk_size

        if world_n > 1 and use_packed and reader_obj is not None and hasattr(
            reader_obj, "set_skip"
        ):
            # decode sharding: this process only parses/encodes/packs the
            # bytes of batches whose every overlapping span it owns (spans
            # are round-robin by index; the feeder's span size is fixed for
            # the whole run, so ownership indexing is process-invariant).
            # Inflate + newline cutting still run everywhere (single-member
            # gzip is not seekable); the N-times-redundant parse/2-bit-
            # encode/pack — the dominant decode cost — is eliminated.
            _span_fixed = span

            def _skip_pred(r0: int, r1: int) -> bool:
                s0 = r0 // _span_fixed
                s1 = max(r0, r1 - 1) // _span_fixed
                return all(
                    (s % world_n) != world_pid for s in range(s0, s1 + 1)
                )

            reader_obj.set_skip(_skip_pred)

        from itertools import chain

        stream = chain([first], batches)
        feeder = SpanFeeder(span, paired)

        with profile():
            # up to `inflight_batches` spans dispatched ahead; a dedicated
            # emission worker runs finalize (device collect + short-read
            # patch + TSV emit) so the main thread only dispatches — host
            # IO (feeder thread), the device wire, and emission CPU all
            # overlap. The bounded queue is the in-flight cap: a slow
            # worker backpressures dispatch.
            import queue as _equeue
            import threading as _ethreading

            def patch_short(r, out, sb):
                # group-probe short-read repair (align/host_probe.py): rows
                # whose shortest mate is under k+g-1 get exact host mono
                # results instead of the group path's unmapped verdict
                group_g = (
                    stacked.group_g
                    if stacked is not None
                    else (r.engine.params.group_g if r.engine else 0)
                )
                if out is None or group_g < 2:
                    return
                l1 = trimmed_lens(sb["r1_lens"], r.trim)
                if int(l1.min(initial=1 << 30)) >= r.index.k + group_g - 1 and (
                    not paired
                    or int(
                        trimmed_lens(sb["r2_lens"], r.trim).min(
                            initial=1 << 30
                        )
                    )
                    >= r.index.k + group_g - 1
                ):
                    return  # fast path: no short reads in this span
                if out.get("band_rows") is not None:
                    # rare: short reads in a banded-wire span — densify so
                    # patch_short_reads can write mono rows in place
                    from nimble_tpu.align.engine import expand_band_rows_np

                    Pw, W = out.pop("band_meta")
                    out["bits"] = expand_band_rows_np(
                        out.pop("band_rows"), Pw, W
                    )
                elif out.get("ids") is not None:
                    from nimble_tpu.align.engine import ids_to_bits_np

                    out["bits"] = ids_to_bits_np(
                        out.pop("ids"), r.index.bitset_words
                    )
                from nimble_tpu.align.host_probe import (
                    HostMonoProber,
                    patch_short_reads,
                )

                prober = getattr(r, "_short_prober", None)
                if prober is None:
                    prober = HostMonoProber(r.index, r.config, strand_filter)
                    r._short_prober = prober
                l2 = trimmed_lens(sb["r2_lens"], r.trim) if paired else None
                n_rows = min(len(l1), out["pass_"].shape[0])
                patched = patch_short_reads(
                    prober, out, sb, l1[:n_rows],
                    l2[:n_rows] if l2 is not None else None, group_g,
                )
                if patched:
                    log.event("short_read_patch", rows=patched)

            def finalize(entry):
                nonlocal total
                reads_end, n, handles, sb, span_idx = entry
                pre = (
                    [r._file.tell() for r in runners] if world_n > 1 else None
                )
                if stacked is not None:
                    outs = stacked.collect_async(handles)
                    for r, out in zip(runners, outs or []):
                        patch_short(r, out, sb)
                        r.emit_out(out, sb)
                else:
                    for r, h in zip(runners, handles):
                        # keep banded-wire spans in narrow band-row form:
                        # emission resolves classes on (n, 1+2Pw) rows
                        # (resolve_features_band) instead of dense W
                        out = r.engine.collect_async(h, expand_band=False)
                        patch_short(r, out, sb)
                        r.emit_out(out, sb)
                total += n
                tput.add(n)
                if world_n > 1:
                    span_meta.append(
                        (
                            span_idx,
                            {
                                r.final_path: r._file.tell() - p
                                for r, p in zip(runners, pre)
                            },
                        )
                    )
                    save_progress(reads_end, spans=span_meta, total_done=total)
                else:
                    save_progress(reads_end)

            def submit(sb, n):
                # per-runner trim is applied to the lens view only; packed
                # words/N-sidecars are trim-independent (windows beyond the
                # trimmed length are invalidated on device by `inside`)
                if use_packed:
                    if stacked is not None:
                        pb = dict(sb)
                        pb["r1_lens"] = trimmed_lens(sb["r1_lens"], runners[0].trim)
                        if paired:
                            pb["r2_lens"] = trimmed_lens(
                                sb["r2_lens"], runners[0].trim
                            )
                        return stacked.align_packed_async(pb)
                    handles = []
                    for r in runners:
                        pb = dict(sb)
                        pb["r1_lens"] = trimmed_lens(sb["r1_lens"], r.trim)
                        if paired:
                            pb["r2_lens"] = trimmed_lens(sb["r2_lens"], r.trim)
                        handles.append(r.engine.align_packed_async(pb))
                    return handles
                if stacked is not None:
                    l1 = trimmed_lens(sb["r1_lens"], runners[0].trim)
                    l2 = None
                    if paired:
                        l2 = trimmed_lens(sb["r2_lens"], runners[0].trim)
                    return stacked.align_batch_async(
                        sb["r1_codes"], l1, sb.get("r2_codes"), l2
                    )
                handles = []
                for r in runners:
                    l1 = trimmed_lens(sb["r1_lens"], r.trim)
                    l2 = None
                    if paired:
                        l2 = trimmed_lens(sb["r2_lens"], r.trim)
                    handles.append(
                        r.engine.align_batch_async(
                            sb["r1_codes"], l1, sb.get("r2_codes"), l2
                        )
                    )
                return handles

            emitq: "_equeue.Queue" = _equeue.Queue(
                maxsize=max(1, inflight_batches)
            )
            emit_exc: list = []

            def emit_worker():
                while True:
                    item = emitq.get()
                    try:
                        if item is None:
                            return
                        if not emit_exc:  # after a failure: drain, don't work
                            finalize(item)
                    except BaseException as e:  # surfaced via qput/drain
                        emit_exc.append(e)
                    finally:
                        emitq.task_done()

            emit_thread = _ethreading.Thread(target=emit_worker, daemon=True)
            emit_thread.start()

            def _shutdown_emit():
                emitq.put(None)
                emit_thread.join()

            emit_shutdown = _shutdown_emit

            def qput(item):
                while True:
                    if emit_exc:
                        raise emit_exc[0]
                    try:
                        emitq.put(item, timeout=0.5)
                        return
                    except _equeue.Full:
                        continue

            def dispatch(sb):
                nonlocal cursor, span_counter
                if "skip" in sb:
                    # span whose bytes this process never decoded; by the
                    # skip predicate's construction it is never ours
                    span_counter += 1
                    cursor += sb["skip"]
                    return
                n = sb["r1_lens"].shape[0]
                span_idx = span_counter
                span_counter += 1
                cursor += n
                if world_n > 1 and span_idx % world_n != world_pid:
                    return  # another process owns this span
                qput((cursor, n, submit(sb, n), sb, span_idx))

            def drain():
                emitq.join()
                if emit_exc:
                    raise emit_exc[0]

            cursor = reads_done
            # resume: spans before the cursor never re-dispatch (the feeder
            # fast-forwards), so global span indexing restarts at the
            # cursor's span (every checkpointed span is span-aligned)
            span_counter = reads_done // span if span else 0
            span_meta: List[Tuple[int, Dict[str, int]]] = list(resumed_spans)

            def rebuild(newL):
                # longer reads than the auto-sized width: drain the
                # device, rebuild engines at the wider length (docstring:
                # auto max_len). The feeder thread already zero-padded its
                # packed backlog to the new width.
                nonlocal stacked, L
                drain()
                L = newL
                log.event("max_len_rebuild", max_len=L)
                stacked = _build_engines(
                    runners, strand_filter, chunk_size, L, paired,
                    mesh_plan, batch_records, log,
                )

            if use_packed:
                # reader + 2-bit packing run on their own thread: host
                # decode happens entirely behind the dispatch/collect loop.
                # The bounded queue caps buffered spans.
                import queue as _queue
                import threading

                spanq: "_queue.Queue" = _queue.Queue(
                    maxsize=max(2, inflight_batches + 1)
                )

                def feed():
                    from nimble_tpu.io.packing import pack_batch

                    try:
                        to_skip = reads_done
                        L_cur = L
                        for batch in stream:
                            if "skip" in batch:
                                # decode-sharded batch owned by another
                                # process: count it through the feeder so
                                # span indexing/cursors stay aligned (the
                                # resume fast-forward consumes skip counts
                                # exactly like real records)
                                n = batch["skip"]
                                if to_skip >= n:
                                    to_skip -= n
                                    continue
                                if to_skip:
                                    batch = {"skip": n - to_skip}
                                    to_skip = 0
                                for sb in feeder.add(batch):
                                    spanq.put(("span", sb))
                                continue
                            n = batch["r1_lens"].shape[0]
                            if to_skip >= n:
                                to_skip -= n
                                continue
                            if to_skip:
                                batch = _slice_reader_batch(batch, to_skip)
                                to_skip = 0
                            m = (
                                int(np.max(batch["r1_lens"]))
                                if batch["r1_lens"].size
                                else 0
                            )
                            r2l = batch.get("r2_lens")
                            if paired and r2l is not None and r2l.size:
                                m = max(m, int(np.max(r2l)))
                            if m > L_cur:
                                L_cur = min(_round_len(m), reader_len)
                                feeder.repack_width(
                                    (L_cur + 15) // 16, (L_cur + 31) // 32
                                )
                                spanq.put(("rebuild", L_cur))
                            for sb in feeder.add(pack_batch(batch, L_cur)):
                                spanq.put(("span", sb))
                        tail = feeder.flush()
                        if tail is not None:
                            spanq.put(("span", tail))
                        spanq.put(None)
                    except BaseException as e:  # surface to the main thread
                        spanq.put(e)

                feeder_thread = threading.Thread(target=feed, daemon=True)
                feeder_thread.start()
                while True:
                    item = spanq.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    kind, payload = item
                    if kind == "rebuild":
                        rebuild(payload)
                    else:
                        dispatch(payload)
                drain()
            else:
                to_skip = reads_done
                for batch in stream:
                    n = batch["r1_lens"].shape[0]
                    if to_skip >= n:
                        to_skip -= n
                        continue
                    if to_skip:
                        batch = _slice_reader_batch(batch, to_skip)
                        to_skip = 0
                    for sb in feeder.add(batch):
                        dispatch(sb)
                tail = feeder.flush()
                if tail is not None:
                    dispatch(tail)
                drain()
    except Exception:
        # propagate failures as a nonzero exit code like the reference
        # propagates the aligner's (reference: __main__.py:439-440); the
        # .progress.json sidecar survives for `align --resume`
        import traceback

        traceback.print_exc()
        log.event("align_failed", total=total)
        failed = True
    finally:
        if emit_shutdown is not None:
            emit_shutdown()
        for r in runners:
            r.close()
    if failed:
        print(f"align FAILED after {total} read(-pair)s", file=sys.stderr)
        return 1
    if os.path.exists(progress_path):
        os.remove(progress_path)
    if world_n > 1:
        _write_shard_meta(output, world_pid, span_meta, total)
        if world_pid == 0:
            total = _merge_shards(
                output, [r.final_path for r in runners], world_n
            )
            log.event("align_merged", total=total, world_n=world_n)
    stats = tput.final()
    log.event("align_done", total=total, **stats)
    rstats = getattr(reader_obj, "stats", None) if reader_obj is not None else None
    if rstats and rstats.get("skipped_records"):
        log.event("decode_shard", **rstats)
        print(
            f"Decode shard: parsed {rstats['parsed_records']} "
            f"skipped {rstats['skipped_records']} records"
        )
    print(f"Aligned {total} read(-pair)s across {len(runners)} library(ies)")
    return 0
