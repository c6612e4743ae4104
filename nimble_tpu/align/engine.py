"""The device alignment engine: k-mer match + configurable scoring.

This is the device-side replacement for the reference's Rust pseudoaligner
(the entire hot path; reference contract: SURVEY §2.4, nimble/types.py:10-26).
The computation per read(-mate), all jnp/XLA (static shapes, no host
round-trips inside a batch):

  1. 2-bit packed rolling k-mer codes as (hi, lo) uint32 pairs, with a
     validity mask (no N in window, window inside the read).
  2. Two-choice bucketed hash probe of the device-resident index: exactly two
     8-slot bucket-row gathers + compares per k-mer (+ a tiny stash sweep)
     -> per-position equivalence-class ids.
  3. Coverage score = number of read bases covered by >= 1 matching k-mer
     ("score in bp", matching the reference's score unit; reference:
     report_generation.py:279), via a cumulative-sum window trick.
  4. Kallisto-style feature intersection: bitwise AND over the class bitsets
     of all matched positions.
  5. Forward and reverse-complement orientations scored independently
     (the reference reports r1_forward_score/r2_forward_score columns);
     orientation selected per the strand filter.
  6. Mate combination per Config.intersect_level / require_valid_pair, and
     score filters (score_threshold, score_filter, score_percent).

Set-size filters (discard_multiple_matches, discard_multi_hits,
max_hits_to_report) and group_on collapse operate on the decoded feature
sets host-side (see align/pipeline.py) — they are O(reported reads), not
O(read bases), so they are not on the hot path.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from nimble_tpu import accel
from nimble_tpu.config import Config
from nimble_tpu.index.builder import BUCKET_SLOTS, STASH_SIZE, KmerIndex
from nimble_tpu.index.hashing import bucket_hashes_jnp

N_CODE = 4


@dataclass(frozen=True)
class AlignParams:
    """Static (trace-time) alignment parameters derived from Config."""

    k: int
    n_buckets: int
    score_threshold: int
    score_filter: int
    score_percent: float
    intersect_level: int
    require_valid_pair: bool
    strand_filter: str  # "unstranded" | "fiveprime" | "threeprime"
    stride: int = 1  # probe every stride-th window (1 = every position)
    # group-probe mode: one (k+g-1)-mer row gather answers g windows
    # (0 = disabled; set by AlignEngine when the index carries group entries)
    group_g: int = 0

    @classmethod
    def from_config(cls, config: Config, index: KmerIndex, strand_filter: str = "unstranded"):
        return cls(
            k=index.k,
            n_buckets=index.n_buckets,
            score_threshold=int(config.score_threshold),
            score_filter=int(config.score_filter),
            score_percent=float(config.score_percent),
            intersect_level=int(config.intersect_level),
            require_valid_pair=bool(config.require_valid_pair),
            strand_filter=strand_filter,
            stride=int(getattr(config, "kmer_stride", 1)),
        )


# inline the class bitsets into bucket rows when they are this narrow or
# less: carrying the bitsets in the bucket row removes the separate
# class-table gather entirely (2 gather rows per window instead of 3)
INLINE_BITS_MAX_WORDS = 16  # up to 512 features

# single-hash ("mono") mode: one bucket of MONO_SLOTS entries per hash at
# expected load <= 0.5 keys/bucket, so a probe is ONE row gather per window
# (overflow keys go to a vector-swept stash). 4-slot 160-byte rows were
# chosen over 8-slot 320-byte rows and the two-choice layout by a row-width
# A/B (scripts/rowwidth.py) that has not been repeated on the H100.
MONO_SLOTS = 4
MONO_MAX_STASH = 64
MONO_TIGHT_STASH = 8  # grow the table rather than exceed this

# group-probe rows are S*(2 + 2*W + 1) int32 (the g windows' bitsets are
# pre-ANDed at build time, so the row width is constant in g); cap W so the
# row stays narrow (W=8 -> 304 bytes at MONO_SLOTS=4)
GROUP_MAX_WORDS = 8

# wide-W (W > 32) intersection: class_bits rows gathered RUN_BLOCK run-start
# classes at a time inside a data-adaptive while_loop (intersect_class_bits)
RUN_BLOCK = 8

# auto chunk sizing: budget the dominant per-read intermediates against
# AUTO_CHUNK_BUDGET bytes of device transients and round to a power of two
# (stable compile-cache keys). On the CPU backend chunks stay at most
# CPU_CHUNK_MAX reads (virtual CPU meshes: keep host RAM sane).
# Sweep on an H100 80GB HBM3 at a 400 W power limit (chunk 16384/65536/
# 131072 x scan 1/8, PERF.md): with scan 8 the HLA-100 step is fastest at
# 65536 reads (104 M reads/s device-resident vs 84 at 16384 and 99 at
# 131072) and the wide library's host-in/out rate falls as chunks grow
# (6.2, 5.1, 4.1 M reads/s), so chunks stop at 65536.
AUTO_CHUNK_BUDGET = 1 << 30
AUTO_CHUNK_MIN = 1 << 10
AUTO_CHUNK_MAX = 1 << 16
CPU_CHUNK_MAX = 1 << 13
# chunks per scanned dispatch on an accelerator (AlignEngine.__init__).
# The emission cap and the compact/idlist/banded wires exist only on the
# scanned path; in the same sweep they make the wide library 9-13x faster
# with host transfers counted (idlist 4.1-6.2 M reads/s vs 0.39-0.46 for
# the full W+3 wire) although one chunk per call is faster device-resident.
SCAN_CHUNKS_DEFAULT = 8


@functools.lru_cache(maxsize=None)
def mono_max_bytes() -> int:
    """Largest single-hash table the mono/group layouts may build: a share
    of the engine device's memory (accel.table_bytes_cap), or the explicit
    NIMBLE_TPU_MONO_MAX_BYTES. The auto chunk sizer accounts for resident
    tables, so a bigger table shrinks transients, not correctness."""
    env = os.environ.get("NIMBLE_TPU_MONO_MAX_BYTES")
    if env:
        return int(env)
    return accel.table_bytes_cap(accel.memory_bytes())


def _chunk_from_per_read(per_read_i32: int, paired: bool) -> int:
    bytes_per_read = per_read_i32 * 4 * (2 if paired else 1)
    chunk = max(AUTO_CHUNK_BUDGET // max(bytes_per_read, 1), 1)
    chunk = 1 << int(np.log2(chunk))
    if not accel.on_accelerator():
        chunk = min(chunk, CPU_CHUNK_MAX)
    return int(np.clip(chunk, AUTO_CHUNK_MIN, AUTO_CHUNK_MAX))


def auto_chunk_size(
    index: KmerIndex,
    max_len: int,
    paired: bool = False,
    group_ok: bool = True,
) -> int:
    """Largest power-of-two chunk whose per-chunk transient working set fits
    AUTO_CHUNK_BUDGET, by engine path. Used when chunk_size is not given —
    the CLI and bench share this, so benchmarked throughput is what `align`
    actually delivers."""
    k = index.k
    L = max(max_len, k)
    P = L - k + 1
    W = index.bitset_words
    S = BUCKET_SLOTS
    if group_ok and index.has_pairs and W <= GROUP_MAX_WORDS:
        g = index.pair_g
        PP = max(L - (k + g - 1) + 1, 1)
        Q = (PP + g - 1) // g + 1
        per_read = Q * S * (2 + 2 * W + 1) + 4 * Q * W + 10 * PP + 6 * P
    elif W <= INLINE_BITS_MAX_WORDS:
        per_read = P * S * (2 + 2 * W) + 2 * P * W + 10 * P
    elif group_ok and index.has_pairs:
        g = index.pair_g
        PP = max(L - (k + g - 1) + 1, 1)
        Q = (PP + g - 1) // g + 1
        bands = _build_class_bands(index)
        if bands is not None:
            # banded group path: 20-word probe rows + one (1+Wb)-word
            # selected-half band row per position, tree transients ~3x
            Wb = 2 * bands[0]
            per_read = Q * (5 * MONO_SLOTS + 3 * (1 + Wb)) + 10 * PP
        else:
            # wide groupcls path: probe rows S*(2+2g+1) per group position
            # plus the runs intersection's (chunk, RUN_BLOCK, W) block
            per_read = (
                Q * MONO_SLOTS * (2 + 2 * g + 1)
                + 6 * Q * g
                + 10 * PP
                + RUN_BLOCK * W
            )
    else:
        # wide monocls (or two-choice fallback) path
        bands = _build_class_bands(index)
        blk = RUN_BLOCK * (
            (1 + 4 * bands[0]) if bands is not None else W
        )
        per_read = P * 4 * MONO_SLOTS + 12 * P + blk
    return _chunk_from_per_read(per_read, paired)


def _device_tables(index: KmerIndex, inline_ok: bool = True, group_ok: bool = True):
    """Index tensors as a pytree of jnp arrays.

    The hash table ships as ONE interleaved (n_buckets, row_width) int32
    array so a probe is a single contiguous row gather per hash candidate.
    Row layout: [hi x S | lo x S | val_same x S | val_diff x S] and, for
    narrow feature spaces (see INLINE_BITS_MAX_WORDS), additionally
    [vs_bits (S x W) | vd_bits (S x W)] — the equivalence-class bitsets of
    each slot's two orientations, inlined so intersection needs no separate
    class gather. Orientation absence is encoded as an all-zero bitset
    (classes always have >= 1 feature, so real bitsets are nonzero).

    All gathered tables are stored as int32 bit-patterns: uint32 gathers
    compile pathologically slowly in this XLA build, and bitwise equality /
    AND are sign-agnostic. Queries are bitcast before comparison."""
    nb = index.n_buckets
    S = BUCKET_SLOTS
    W = index.bitset_words
    inline = inline_ok and W <= INLINE_BITS_MAX_WORDS

    class_bits_i32 = index.class_bits.view(np.int32)

    def bits_of(vals: np.ndarray) -> np.ndarray:
        out = np.zeros((vals.shape[0], W), dtype=np.int32)
        occ = vals >= 0
        out[occ] = class_bits_i32[vals[occ]]
        return out

    width = 4 * S + (2 * S * W if inline else 0)
    packed = np.empty((nb, width), dtype=np.int32)
    packed[:, 0:S] = index.table_hi.reshape(nb, S).view(np.int32)
    packed[:, S : 2 * S] = index.table_lo.reshape(nb, S).view(np.int32)
    packed[:, 2 * S : 3 * S] = index.table_vsame.reshape(nb, S)
    packed[:, 3 * S : 4 * S] = index.table_vdiff.reshape(nb, S)
    as_i32 = lambda a: jnp.asarray(a.view(np.int32))
    tables = {
        "bucket": None,  # filled below
        "stash_hi": as_i32(index.stash_hi),
        "stash_lo": as_i32(index.stash_lo),
        "stash_vsame": jnp.asarray(index.stash_vsame),
        "stash_vdiff": jnp.asarray(index.stash_vdiff),
        "class_bits": as_i32(index.class_bits),
    }
    if inline:
        packed[:, 4 * S : 4 * S + S * W] = bits_of(
            index.table_vsame
        ).reshape(nb, S * W)
        packed[:, 4 * S + S * W :] = bits_of(index.table_vdiff).reshape(nb, S * W)
        tables["stash_vs_bits"] = jnp.asarray(bits_of(index.stash_vsame))
        tables["stash_vd_bits"] = jnp.asarray(bits_of(index.stash_vdiff))
    tables["bucket"] = jnp.asarray(packed)
    group = None
    if inline and group_ok and index.has_pairs and W <= GROUP_MAX_WORDS:
        group = _build_group_tables(index, bits_of)
    elif not inline and group_ok and index.has_pairs:
        # wide feature space: banded pre-ANDed group payloads when class
        # supports are narrow (the common family-contiguous case), else the
        # class-id group probe + runs-compacted intersection
        group = _build_groupband_tables(index) or _build_groupcls_tables(index)
    if group is not None:
        # the group probe fully replaces the mono probe (the tail probe also
        # hits the group table), so skip building mono tables
        tables.update(group)
        if not inline:
            # wide group paths never trace the two-choice mono tables, and
            # the banded path reads only class_bits.shape — ship 1-row
            # placeholders instead of the dead arrays (20k-allele library:
            # ~0.7 GB of transfer and device memory that would otherwise
            # shrink the auto chunk)
            tables["bucket"] = jnp.zeros((1, 4 * S), jnp.int32)
            tables["stash_hi"] = jnp.zeros((0,), jnp.int32)
            tables["stash_lo"] = jnp.zeros((0,), jnp.int32)
            tables["stash_vsame"] = jnp.zeros((0,), jnp.int32)
            tables["stash_vdiff"] = jnp.zeros((0,), jnp.int32)
            if "gband_bucket" in group:
                # banded payloads replace every class-bitset gather
                tables["class_bits"] = jnp.zeros((1, W), jnp.int32)
    elif inline:
        mono = _build_mono_tables(index, bits_of)
        if mono is not None:
            tables.update(mono)
    else:
        # wide feature space, no group entries: single-hash class-id table
        # (one row gather per window vs the two-choice probe's two), with
        # banded class rows for the runs intersection when supports allow
        mcls = _build_monocls_tables(index)
        if mcls is not None:
            tables.update(mcls)
        bands = _build_class_bands(index)
        if bands is not None:
            tables["class_bandrow"] = jnp.asarray(bands[1])
    return tables


def _build_group_tables(index: KmerIndex, bits_of):
    """Group-probe table: single-hash buckets over the index's canonical
    (k+g-1)-mer entries (index.pair_*), with the g windows' class bitsets
    PRE-ANDed at build time — the device intersection only ever ANDs them,
    so one (W,)-word plane per orientation carries the whole group's
    contribution exactly, keeping the row width CONSTANT in g:

      [hi x S | lo x S | vs_and (W,S) | vd_and (W,S) | mask x S]

    vs_and/vd_and = AND of the present windows' bitsets for the canonical
    code / its reverse complement (identity when none), and mask packs four
    g-bit per-window presence fields (g <= 8):
      bits 0..g-1   vs_mask   (canonical code's window i present)
      bits 8..      vd_mask
      bits 16..     vs_mask reversed within g  (for the rev orientation's
      bits 24..     vd_mask reversed            forward-coordinate windows)
    Empty slots carry the impossible key hi = 0xFFFFFFFF. Returns None when
    placement blows the memory/stash budget (caller falls back to mono)."""
    g = index.pair_g
    W = index.bitset_words
    hi = index.pair_hi
    lo = index.pair_lo
    n = hi.shape[0]
    if n == 0 or g > 8:
        return None
    entry = 2 + 2 * W + 1
    placement = _single_hash_placement(hi, lo, entry, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    vs_and, vd_and, mask_word = _group_entry_payload(index, bits_of)

    S = MONO_SLOTS
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    for w in range(W):
        table[b, 2 * S + w * S + s] = vs_and[keys, w]
        table[b, 2 * S + W * S + w * S + s] = vd_and[keys, w]
    table[b, 2 * S + 2 * W * S + s] = mask_word[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    gs = {
        "hi": np.full(pad, -1, dtype=np.int32),  # padding can never match
        "lo": np.zeros(pad, dtype=np.int32),
        "vs_and": np.zeros((pad, W), dtype=np.int32),
        "vd_and": np.zeros((pad, W), dtype=np.int32),
        "mask": np.zeros(pad, dtype=np.int32),
    }
    if n_stash:
        gs["hi"][:n_stash] = hi[skeys].view(np.int32)
        gs["lo"][:n_stash] = lo[skeys].view(np.int32)
        gs["vs_and"][:n_stash] = vs_and[skeys]
        gs["vd_and"][:n_stash] = vd_and[skeys]
        gs["mask"][:n_stash] = mask_word[skeys]
    return {
        "group_bucket": jnp.asarray(table),
        "group_stash_hi": jnp.asarray(gs["hi"]),
        "group_stash_lo": jnp.asarray(gs["lo"]),
        "group_stash_vs_and": jnp.asarray(gs["vs_and"]),
        "group_stash_vd_and": jnp.asarray(gs["vd_and"]),
        "group_stash_mask": jnp.asarray(gs["mask"]),
    }


def _group_entry_payload(index: KmerIndex, bits_of):
    """Per pair-entry group payload: (vs_and, vd_and, mask_word) as described
    in _build_group_tables — the g windows' class bitsets pre-ANDed per
    orientation plus the packed 4x g-bit presence mask. Shared by the
    single-library group table and the stacked multi-library one
    (align/stacked.build_stacked_group_tables)."""
    g = index.pair_g
    W = index.bitset_words
    vals = index.pair_vals
    n = index.pair_hi.shape[0]

    def and_mask(cols):  # cols: (n, g) class ids -> (and_bits (n,W), mask (n,))
        acc = np.full((n, W), -1, dtype=np.int32)
        mask = np.zeros(n, dtype=np.int32)
        for i in range(cols.shape[1]):
            present = cols[:, i] >= 0
            cbits = bits_of(cols[:, i])
            acc[present] &= cbits[present]
            mask |= present.astype(np.int32) << i
        return acc, mask

    vs_and, vs_mask = and_mask(vals[:, :g])
    vd_and, vd_mask = and_mask(vals[:, g:])
    rev = lambda m: sum(((m >> i) & 1) << (g - 1 - i) for i in range(g))
    mask_word = vs_mask | (vd_mask << 8) | (rev(vs_mask) << 16) | (rev(vd_mask) << 24)
    return vs_and, vd_and, mask_word


def _single_hash_placement(hi: np.ndarray, lo: np.ndarray, entry_words: int, slots: int):
    """Grow-until-tight single-hash placement shared by the mono and group
    table layouts: reinsert all keys by h1 into next_pow2(n)*2^extra buckets
    of `slots` slots, growing the table until the overflow stash is tiny —
    every stash entry costs a full (B, P, W) vector sweep per probe, which
    dwarfs the memory cost of more buckets.

    Returns None (placement infeasible under mono_max_bytes()/MONO_MAX_STASH)
    or (nb2, bucket_ids, slot_ids, placed_keys, stash_keys): key indices and
    their bucket/slot assignments."""
    from nimble_tpu.index.hashing import bucket_hashes_np

    n = hi.shape[0]
    best = None  # (stash_size, nb2, h_sorted, order, placed)
    for extra in (1, 2, 3, 4, 5, 6):
        nb2 = 1 << max(1, int(np.ceil(np.log2(n))) + extra)
        if nb2 * slots * entry_words * 4 > mono_max_bytes():
            break
        h, _ = bucket_hashes_np(hi, lo, nb2)
        order = np.argsort(h, kind="stable")
        h_sorted = h[order]
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        boundary[1:] = h_sorted[1:] != h_sorted[:-1]
        start = np.flatnonzero(boundary)
        group = np.cumsum(boundary) - 1
        rank = np.arange(n) - start[group]
        placed = rank < slots
        n_over = int((~placed).sum())
        if best is None or n_over < best[0]:
            best = (n_over, nb2, h_sorted, order, rank, placed)
        if n_over <= MONO_TIGHT_STASH:
            break
    if best is None or best[0] > MONO_MAX_STASH:
        return None
    _, nb2, h_sorted, order, rank, placed = best
    return (
        nb2,
        h_sorted[placed].astype(np.int64),
        rank[placed].astype(np.int64),
        order[placed],
        order[~placed],
    )


def _two_choice_placement(hi: np.ndarray, lo: np.ndarray, slots: int,
                          stash_cap: int = 64):
    """Greedy two-choice placement (vectorized rounds, no eviction) of keys
    into next_pow2-sized bucket tables, growing until the overflow stash
    fits stash_cap. Densities reach ~16x the grow-until-tight single-hash
    placement (the 20k-allele gband bucket shrank 33.5M -> 2M buckets /
    2.7 GB -> 160 MB), at the cost of a second bucket gather per probe.

    Returns (nb2, bucket_ids, slot_ids, placed_keys, stash_keys)."""
    from nimble_tpu.index.hashing import bucket_hashes_np

    n = hi.shape[0]
    target = max(1, int(np.ceil(n / (slots * 0.6))))
    nb2 = 1 << max(1, int(np.ceil(np.log2(target))))
    for _ in range(4):
        h1, h2 = bucket_hashes_np(hi, lo, nb2)
        slot_key = np.full(nb2 * slots, -1, dtype=np.int64)
        loads = np.zeros(nb2, dtype=np.int32)
        pending = np.arange(n)
        # greedy lesser-loaded rounds place the easy ~99.9%
        for _r in range(16):
            if pending.size == 0:
                break
            p1, p2 = h1[pending], h2[pending]
            tgt = np.where(loads[p1] <= loads[p2], p1, p2).astype(np.int64)
            order = np.argsort(tgt, kind="stable")
            t_sorted = tgt[order]
            boundary = np.empty(t_sorted.shape[0], dtype=bool)
            boundary[0] = True
            boundary[1:] = t_sorted[1:] != t_sorted[:-1]
            group_start = np.flatnonzero(boundary)
            rank = (
                np.arange(t_sorted.shape[0])
                - group_start[np.cumsum(boundary) - 1]
            )
            slot = loads[t_sorted] + rank
            ok = slot < slots
            slot_key[t_sorted[ok] * slots + slot[ok]] = pending[order[ok]]
            np.add.at(loads, t_sorted[ok], 1)
            pending = pending[order[~ok]]
        # random-walk cuckoo eviction rounds drain the stranded tail
        # (greedy-no-eviction leaves thousands at load ~0.5; (2,slots)-
        # cuckoo converges far above that)
        rng = np.random.default_rng(0x1C0FFEE)
        for _r in range(512):
            if pending.size <= stash_cap:
                break
            p1, p2 = h1[pending], h2[pending]
            pick = rng.integers(0, 2, size=pending.size) == 1
            tgt = np.where(pick, p1, p2).astype(np.int64)
            order = np.argsort(tgt, kind="stable")
            t_sorted = tgt[order]
            first = np.empty(t_sorted.size, dtype=bool)
            first[0] = True
            first[1:] = t_sorted[1:] != t_sorted[:-1]
            win = order[first]  # one winner per bucket this round
            flat = tgt[win] * slots + rng.integers(0, slots, size=win.size)
            evicted = slot_key[flat]
            slot_key[flat] = pending[win]
            keep = np.ones(pending.size, dtype=bool)
            keep[win] = False
            pending = np.concatenate([pending[keep], evicted[evicted >= 0]])
        if pending.size <= stash_cap:
            occ = np.flatnonzero(slot_key >= 0)
            return (
                nb2,
                occ // slots,
                occ % slots,
                slot_key[occ],
                pending,
            )
        nb2 <<= 1
    return None


def _build_mono_tables(index: KmerIndex, bits_of):
    """Single-hash bucket layout: every occupied entry reinserted by h1 into
    next_pow2(n_keys) buckets of MONO_SLOTS slots (expected load <= 1/bucket).
    Entry layout per slot: [hi, lo, vs_bits(W), vd_bits(W)]; a bucket row is
    MONO_SLOTS entries -> ONE contiguous row gather answers a whole probe.
    Returns None (caller keeps two-choice) when memory or stash would blow."""
    W = index.bitset_words
    occ = (index.table_vsame >= 0) | (index.table_vdiff >= 0)
    his = [index.table_hi[occ]]
    los = [index.table_lo[occ]]
    vss = [index.table_vsame[occ]]
    vds = [index.table_vdiff[occ]]
    socc = (index.stash_vsame >= 0) | (index.stash_vdiff >= 0)
    his.append(index.stash_hi[socc])
    los.append(index.stash_lo[socc])
    vss.append(index.stash_vsame[socc])
    vds.append(index.stash_vdiff[socc])
    hi = np.concatenate(his)
    lo = np.concatenate(los)
    vs = np.concatenate(vss)
    vd = np.concatenate(vds)
    n = hi.shape[0]
    if n == 0:
        return None
    entry = 2 + 2 * W
    placement = _single_hash_placement(hi, lo, entry, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    vs_bits = bits_of(vs)
    vd_bits = bits_of(vd)
    # PLANAR row layout (slot-minor within each field) so every post-gather
    # slice is contiguous: [hi x S | lo x S | vs_bits (W, S) | vd_bits (W, S)]
    # Empty slots carry the impossible key hi = 0xFFFFFFFF (canonical codes
    # have hi < 2^30 for k <= 31), so the probe needs no occupancy check.
    S = MONO_SLOTS
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    for w in range(W):
        table[b, 2 * S + w * S + s] = vs_bits[keys, w]
        table[b, 2 * S + W * S + w * S + s] = vd_bits[keys, w]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    ms_hi = np.zeros(pad, dtype=np.int32)
    ms_lo = np.zeros(pad, dtype=np.int32)
    ms_vsb = np.zeros((pad, W), dtype=np.int32)
    ms_vdb = np.zeros((pad, W), dtype=np.int32)
    ms_hi[:] = -1  # EMPTY sentinel: padding rows can never match a query
    if n_stash:
        ms_hi[:n_stash] = hi[skeys].view(np.int32)
        ms_lo[:n_stash] = lo[skeys].view(np.int32)
        ms_vsb[:n_stash] = vs_bits[skeys]
        ms_vdb[:n_stash] = vd_bits[skeys]
    return {
        "mono_bucket": jnp.asarray(table),
        "mono_stash_hi": jnp.asarray(ms_hi),
        "mono_stash_lo": jnp.asarray(ms_lo),
        "mono_stash_vs_bits": jnp.asarray(ms_vsb),
        "mono_stash_vd_bits": jnp.asarray(ms_vdb),
    }


def _build_monocls_tables(index: KmerIndex):
    """Wide-W (W > INLINE_BITS_MAX_WORDS) single-hash table whose payload is
    CLASS IDS instead of inlined bitsets: entry [hi, lo, val_same, val_diff]
    (4 words), planar row [hi x S | lo x S | vs x S | vd x S] — ONE 64-byte
    row gather per window replaces the two-choice probe's two gathers, and
    the feature bitsets are resolved afterwards by the runs-compacted
    intersection (intersect_class_bits). Exact mono semantics at any W.
    Returns None when placement blows the memory/stash budget (caller keeps
    the two-choice probe)."""
    occ = (index.table_vsame >= 0) | (index.table_vdiff >= 0)
    socc = (index.stash_vsame >= 0) | (index.stash_vdiff >= 0)
    hi = np.concatenate([index.table_hi[occ], index.stash_hi[socc]])
    lo = np.concatenate([index.table_lo[occ], index.stash_lo[socc]])
    vs = np.concatenate([index.table_vsame[occ], index.stash_vsame[socc]])
    vd = np.concatenate([index.table_vdiff[occ], index.stash_vdiff[socc]])
    if hi.shape[0] == 0:
        return None
    placement = _single_hash_placement(hi, lo, 4, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    S = MONO_SLOTS
    table = np.zeros((nb2, S * 4), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[:, 2 * S :] = -1  # class planes default to miss
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    table[b, 2 * S + s] = vs[keys]
    table[b, 3 * S + s] = vd[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    ms = {
        "hi": np.full(pad, -1, dtype=np.int32),  # padding can never match
        "lo": np.zeros(pad, dtype=np.int32),
        "vs": np.full(pad, -1, dtype=np.int32),
        "vd": np.full(pad, -1, dtype=np.int32),
    }
    if n_stash:
        ms["hi"][:n_stash] = hi[skeys].view(np.int32)
        ms["lo"][:n_stash] = lo[skeys].view(np.int32)
        ms["vs"][:n_stash] = vs[skeys]
        ms["vd"][:n_stash] = vd[skeys]
    return {
        "mcls_bucket": jnp.asarray(table),
        "mcls_stash_hi": jnp.asarray(ms["hi"]),
        "mcls_stash_lo": jnp.asarray(ms["lo"]),
        "mcls_stash_vs": jnp.asarray(ms["vs"]),
        "mcls_stash_vd": jnp.asarray(ms["vd"]),
    }


def _build_groupcls_tables(index: KmerIndex):
    """Wide-W group-probe table: single-hash buckets over the canonical
    (k+g-1)-mer entries with the g windows' CLASS IDS as payload (the
    narrow-W group table pre-ANDs W-word bitsets per slot, which at W=625
    would make 20 KB rows):

      [hi x S | lo x S | cls cols (2g, S) | mask x S]

    cols 0..g-1 = canonical code's window classes (vs), cols g..2g-1 = its
    reverse complement's (vd); mask packs the same four g-bit presence
    fields as _build_group_tables. One 240-byte row gather (g=6) answers g
    windows in both orientations; the intersection resolves class ids to
    bitsets afterwards (runs-compacted, intersect_class_bits). Same
    conservative divergence semantics as the narrow group probe."""
    g = index.pair_g
    hi = index.pair_hi
    lo = index.pair_lo
    vals = index.pair_vals
    n = hi.shape[0]
    if n == 0 or g > 8:
        return None
    entry = 2 + 2 * g + 1
    placement = _single_hash_placement(hi, lo, entry, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    present = (vals >= 0).astype(np.int32)
    vs_mask = np.zeros(n, dtype=np.int32)
    vd_mask = np.zeros(n, dtype=np.int32)
    for i in range(g):
        vs_mask |= present[:, i] << i
        vd_mask |= present[:, g + i] << i
    rev = lambda m: sum(((m >> i) & 1) << (g - 1 - i) for i in range(g))
    mask_word = (
        vs_mask | (vd_mask << 8) | (rev(vs_mask) << 16) | (rev(vd_mask) << 24)
    )

    S = MONO_SLOTS
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[:, 2 * S : 2 * S + 2 * g * S] = -1  # class planes default to miss
    table[b, s] = hi[keys].view(np.int32)
    table[b, S + s] = lo[keys].view(np.int32)
    for c in range(2 * g):
        table[b, 2 * S + c * S + s] = vals[keys, c]
    table[b, 2 * S + 2 * g * S + s] = mask_word[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    gs_hi = np.full(pad, -1, dtype=np.int32)
    gs_lo = np.zeros(pad, dtype=np.int32)
    gs_cols = np.full((pad, 2 * g), -1, dtype=np.int32)
    gs_mask = np.zeros(pad, dtype=np.int32)
    if n_stash:
        gs_hi[:n_stash] = hi[skeys].view(np.int32)
        gs_lo[:n_stash] = lo[skeys].view(np.int32)
        gs_cols[:n_stash] = vals[skeys]
        gs_mask[:n_stash] = mask_word[skeys]
    return {
        "groupcls_bucket": jnp.asarray(table),
        "groupcls_stash_hi": jnp.asarray(gs_hi),
        "groupcls_stash_lo": jnp.asarray(gs_lo),
        "groupcls_stash_cols": jnp.asarray(gs_cols),
        "groupcls_stash_mask": jnp.asarray(gs_mask),
    }


def _build_class_bands(index: KmerIndex):
    """Banded (page-aligned compressed) class bitsets for wide feature
    spaces. Observation: an equivalence class's member features are nearly
    always CONTIGUOUS in library order (alleles of one gene family), so its
    (W,)-word bitset is nonzero only within a short span. Store each class
    as a 2-page band at a page-aligned offset:

      page size Pw = roundup8(max span over classes) words; a span <= Pw
      always fits inside the aligned 2-page window starting at
      floor(first_word / Pw) (distance to the page start <= Pw-1, so
      first + span <= page*Pw + 2*Pw).

    Page-aligned offsets make band intersection BRANCH-STATIC: two bands'
    relative shift is a whole number of pages, and |shift| >= 2 means no
    overlap (empty intersection), so the combine is a 3-way select of
    statically shifted ANDs (_band_combine) — no per-row dynamic gathers.

    Returns (Pw, bandrow) with bandrow (C, 1 + 2*Pw) int32 rows
    [page | band words], or None when banding isn't worth it
    (3 * Pw > W). Cached on the index object."""
    cached = getattr(index, "_band_cache", "unset")
    if cached != "unset":
        return cached
    W = index.bitset_words
    cb = index.class_bits.view(np.int32)
    C = cb.shape[0]
    result = None
    if C and W > INLINE_BITS_MAX_WORDS:
        nz = cb != 0
        any_nz = nz.any(axis=1)
        first = np.where(any_nz, nz.argmax(axis=1), 0)
        last = np.where(any_nz, W - 1 - nz[:, ::-1].argmax(axis=1), 0)
        span = int(np.max(last - first + 1)) if C else 1
        Pw = max(8, -(-span // 8) * 8)
        if 3 * Pw <= W:
            pages = (first // Pw).astype(np.int32)
            Wpad = (-(-W // Pw) + 1) * Pw
            cbp = np.zeros((C, Wpad), dtype=np.int32)
            cbp[:, :W] = cb
            idx = pages[:, None] * Pw + np.arange(2 * Pw)[None, :]
            band = np.take_along_axis(cbp, idx, axis=1)
            bandrow = np.concatenate([pages[:, None], band], axis=1)
            result = (Pw, bandrow)
    index._band_cache = result
    return result


# classes allowed to exceed the page span before robust banding gives up
BAND_OUTLIER_CAP = 64

# working-set budget for the gband build's blocked pre-AND (bytes of one
# (block, Wb) int32 plane); tests shrink it to force the multi-block path
GBAND_PREAND_BLOCK_BYTES = 128 << 20


def _build_class_bands_robust(index: KmerIndex):
    """_build_class_bands tolerant of a FEW wide-span outlier classes.

    Real libraries always contain a handful of classes whose features
    span multiple gene families (chance k-mer collisions between family
    backbones — the 50k-feature probe found 3 of 578,899 classes with
    span up to 668 words, which made the strict max-span Pw fail
    3*Pw <= W and silently knocked the whole library off the banded
    group path). Here Pw comes from the fitting majority; classes whose
    bitset does not fit an aligned 2-page window are marked not-ok (their
    band rows are zeroed) and the caller must handle entries touching
    them exactly (full-width) — _build_groupband_tables does.

    Returns (Pw, bandrow, ok_mask) or None when more than
    BAND_OUTLIER_CAP classes misfit (banding genuinely inapplicable)."""
    cached = getattr(index, "_band_cache_robust", "unset")
    if cached != "unset":
        return cached
    result = None
    strict = _build_class_bands(index)
    if strict is not None:
        Pw, bandrow = strict
        result = (Pw, bandrow, np.ones(bandrow.shape[0], dtype=bool))
    else:
        W = index.bitset_words
        cb = index.class_bits.view(np.int32)
        C = cb.shape[0]
        if C and W > INLINE_BITS_MAX_WORDS:
            nz = cb != 0
            any_nz = nz.any(axis=1)
            first = np.where(any_nz, nz.argmax(axis=1), 0)
            last = np.where(any_nz, W - 1 - nz[:, ::-1].argmax(axis=1), 0)
            span = last - first + 1
            Pw = max(8, -(-int(np.percentile(span, 99.99)) // 8) * 8)
            ok = (last // Pw - first // Pw) <= 1
            if 3 * Pw <= W and int((~ok).sum()) <= BAND_OUTLIER_CAP:
                pages = np.where(ok, first // Pw, 0).astype(np.int32)
                Wpad = (-(-W // Pw) + 1) * Pw
                cbp = np.zeros((C, Wpad), dtype=np.int32)
                cbp[ok, :W] = cb[ok]  # outlier rows stay zero
                idx = pages[:, None] * Pw + np.arange(2 * Pw)[None, :]
                band = np.take_along_axis(cbp, idx, axis=1)
                bandrow = np.concatenate([pages[:, None], band], axis=1)
                result = (Pw, bandrow, ok)
    index._band_cache_robust = result
    return result


def _np_band_combine(po, bo, has, pi, bi, pres, Pw):
    """Numpy page-banded AND-combine (build-time pre-AND): fold the banded
    class (pi, bi, pres) into the accumulator (po, bo, has)."""
    n = po.shape[0]
    d = pi - po
    up_o = np.concatenate([bo[:, Pw:], np.zeros((n, Pw), np.int32)], axis=1)
    up_i = np.concatenate([bi[:, Pw:], np.zeros((n, Pw), np.int32)], axis=1)
    nb = np.where((d == 0)[:, None], bo & bi, 0)
    nb = np.where((d == 1)[:, None], up_o & bi, nb)
    nb = np.where((d == -1)[:, None], bo & up_i, nb)
    np_page = np.maximum(po, pi)
    both = has & pres
    bo = np.where(both[:, None], nb, np.where(pres[:, None], bi, bo))
    po = np.where(both, np_page, np.where(pres, pi, po))
    return po, bo, has | pres


def _build_groupband_tables(index: KmerIndex):
    """Wide-W group-probe tables with BANDED PRE-ANDED payloads — the wide
    analog of _build_group_tables' inlined vs_and/vd_and planes, made
    affordable by the page-banded class representation (_build_class_bands):

      probe row  [hi x S | lo x S | entry_idx x S | mask x S]   (64 B)
      band table (n_entries, 2*(1+Wb)) rows
                 [page_s | band_s (Wb) | page_d | band_d (Wb)]

    where band_s/band_d are the g windows' class bands pre-ANDed per
    orientation (page algebra, _np_band_combine) and mask packs the same
    four g-bit presence fields as _build_group_tables. ONE probe-row gather
    plus ONE band-row gather per probe position answers g windows in both
    orientations — no per-window class gathers at all. Returns None when
    banding or placement is infeasible (caller falls back to the class-id
    group table)."""
    bands = _build_class_bands_robust(index)
    if bands is None:
        return None
    Pw, bandrow, band_ok = bands
    Wb = 2 * Pw
    g = index.pair_g
    hi = index.pair_hi
    lo = index.pair_lo
    vals = index.pair_vals
    n = hi.shape[0]
    if n == 0 or g > 8:
        return None
    # Placement (scripts/ab_gband_placement.py A/Bs the two): default
    # sparse single-hash, one gather per probe, chosen because the second
    # bucket gather of the two-choice layout cost more than its 16x denser
    # table saved; not yet re-measured on the H100.
    # NIMBLE_TPU_GBAND_PLACEMENT=two opts into the dense layout (168 MB vs
    # 2.7 GB of device memory) when memory is the binding constraint.
    two_choice = os.environ.get("NIMBLE_TPU_GBAND_PLACEMENT", "single") == "two"
    # the host-side build (pre-AND + dedup) costs minutes at 4.6M entries;
    # cache per index object and layout mode (engine rebuilds reuse it)
    mode_key = (
        two_choice,
        os.environ.get("NIMBLE_TPU_GBAND_INDIRECT", "0") == "1",
    )
    cache = getattr(index, "_gband_cache", None)
    if cache is None:
        cache = {}
        index._gband_cache = cache
    if mode_key in cache:
        return cache[mode_key]

    # disk sidecar next to the persisted index: the host build costs
    # minutes at millions of entries, the load costs seconds. Guarded by a
    # sampled fingerprint of the pair keys (a changed library rebuilds the
    # .idx.npz, so a stale sidecar would otherwise survive).
    def _fingerprint():
        n = index.pair_hi.shape[0]
        step = max(1, n // 997)
        return np.array(
            [
                GBAND_FORMAT_VERSION,
                n,
                int(index.pair_hi[::step].astype(np.int64).sum()),
                int(index.pair_lo[::step].astype(np.int64).sum()),
                index.pair_g,
                index.bitset_words,
            ],
            dtype=np.int64,
        )

    cp = getattr(index, "_cache_path", None)
    tag = ("two" if two_choice else "single") + (
        "" if mode_key[1] else ".dense"
    )
    disk = f"{cp}.gband.{tag}.npz" if cp else None
    if disk and os.path.exists(disk):
        try:
            z = np.load(disk)
            if np.array_equal(z["__fp"], _fingerprint()):
                out = {
                    k: jnp.asarray(z[k]) for k in z.files if k != "__fp"
                }
                cache[mode_key] = out
                return out
        except Exception:
            pass  # unreadable/stale sidecar: rebuild below
    if two_choice:
        placement = _two_choice_placement(hi, lo, MONO_SLOTS)
    else:
        placement = _single_hash_placement(hi, lo, 4, MONO_SLOTS)
    if placement is None:
        return None
    nb2, b, s, keys, skeys = placement

    pages_all = bandrow[:, 0]
    band_all = bandrow[:, 1:]

    def pre_and(cols):  # (n, g) class ids -> (page, band, mask)
        # blocked: _np_band_combine makes ~6 (block, Wb) temporaries per
        # g column; at 11.4M entries x 64 words unblocked that is ~2.9 GB
        # each and the 50k-library sidecar build spent ~18.5 min mostly
        # in allocator churn. ~128 MB blocks keep the working set cached.
        po = np.zeros(n, dtype=np.int32)
        bo = np.zeros((n, Wb), dtype=np.int32)
        mask = np.zeros(n, dtype=np.int32)
        block = max(1, GBAND_PREAND_BLOCK_BYTES // (Wb * 4))
        for lo_i in range(0, n, block):
            hi_i = min(lo_i + block, n)
            cb = cols[lo_i:hi_i]
            pb = po[lo_i:hi_i]
            bb = bo[lo_i:hi_i]
            hb = np.zeros(hi_i - lo_i, dtype=bool)
            mb = mask[lo_i:hi_i]
            for i in range(cb.shape[1]):
                c = cb[:, i]
                pres = c >= 0
                cc = np.clip(c, 0, None)
                pb, bb, hb = _np_band_combine(
                    pb, bb, hb, pages_all[cc], band_all[cc], pres, Pw
                )
                mb |= pres.astype(np.int32) << i
            po[lo_i:hi_i] = pb
            bo[lo_i:hi_i] = bb
            mask[lo_i:hi_i] = mb
        return po, bo, mask

    p_s, b_s, vs_mask = pre_and(vals[:, :g])
    p_d, b_d, vd_mask = pre_and(vals[:, g:])

    if not band_ok.all():
        # exact full-width pre-AND for the few entries touching outlier
        # (misfit) classes; the AND of an outlier with its neighboring
        # windows' narrow classes is almost always narrow again — if any
        # result still misfits its 2-page window, banding is off.
        def fix_touched(cols, po, bo):
            pres_all = cols >= 0
            bad = pres_all & ~band_ok[np.clip(cols, 0, None)]
            rows_idx = np.nonzero(bad.any(axis=1))[0]
            if rows_idx.size == 0:
                return po, bo, True
            cb = index.class_bits.view(np.int32)
            W = index.bitset_words
            acc = np.zeros((rows_idx.size, W), dtype=np.int32)
            has = np.zeros(rows_idx.size, dtype=bool)
            for i in range(cols.shape[1]):
                c = cols[rows_idx, i]
                pres = c >= 0
                row = cb[np.clip(c, 0, None)]
                both = has & pres
                acc = np.where(
                    both[:, None], acc & row,
                    np.where((pres & ~has)[:, None], row, acc),
                )
                has |= pres
            nzm = acc != 0
            anym = nzm.any(axis=1)
            f = np.where(anym, nzm.argmax(axis=1), 0)
            l = np.where(anym, W - 1 - nzm[:, ::-1].argmax(axis=1), 0)
            if np.any((l // Pw - f // Pw) > 1):
                return po, bo, False
            pages = (f // Pw).astype(np.int32)
            Wpad = (-(-W // Pw) + 1) * Pw
            accp = np.zeros((rows_idx.size, Wpad), dtype=np.int32)
            accp[:, :W] = acc
            gidx = pages[:, None] * Pw + np.arange(2 * Pw)[None, :]
            po = po.copy()
            bo = bo.copy()
            po[rows_idx] = pages
            bo[rows_idx] = np.take_along_axis(accp, gidx, axis=1)
            return po, bo, True

        p_s, b_s, ok_s = fix_touched(vals[:, :g], p_s, b_s)
        p_d, b_d, ok_d = fix_touched(vals[:, g:], p_d, b_d)
        if not (ok_s and ok_d):
            return None
    rev = lambda m: sum(((m >> i) & 1) << (g - 1 - i) for i in range(g))
    mask_word = (
        vs_mask | (vd_mask << 8) | (rev(vs_mask) << 16) | (rev(vd_mask) << 24)
    )
    # HALF rows [page | band (Wb)]: the device computes use_fwd from the
    # probe masks alone and gathers only the selected orientation's half
    # (s when fwd_c == use_fwd else d) — half the band-gather bytes and no
    # per-position orientation selects on full-width planes.
    half = np.concatenate(
        [
            np.concatenate([p_s[:, None], b_s], axis=1),
            np.concatenate([p_d[:, None], b_d], axis=1),
        ]
    ).astype(np.int32)

    # Dedup identical half payloads: rows are per (k+g-1)-mer entry and
    # orientation, but adjacent entries inside a family segment share the
    # same pre-ANDed band, so distinct payloads are ~10-20x fewer
    # (20k-allele library: 1.9 GB -> tens of MB of HBM). Hash-unique
    # (random-multiplier int64, exactness verified row-for-row; collision
    # -> exact lexsort unique).
    # column-loop mixing hash (an int64 matmul has no BLAS path and took
    # minutes at 9M x 65); exactness still verified row-for-row below
    hsh = np.zeros(half.shape[0], dtype=np.int64)
    for j in range(half.shape[1]):
        hsh = (hsh ^ half[:, j].astype(np.int64)) * np.int64(
            -7046029254386353131
        )
        hsh ^= hsh >> 29
    _, first_idx, inverse = np.unique(
        hsh, return_index=True, return_inverse=True
    )
    dedup = half[first_idx]
    if np.array_equal(dedup[inverse], half):
        band_table = dedup
        remap = inverse.astype(np.int32)
    else:  # 64-bit collision (~n^2/2^64): exact fallback
        band_table, remap = np.unique(half, axis=0, return_inverse=True)
        remap = remap.astype(np.int32)
    remap_s, remap_d = remap[:n], remap[n:]

    S = MONO_SLOTS
    # Two-level bucket storage: the sparse single-hash placement leaves
    # ~86% of buckets empty, and row-gather cost can grow with the
    # table's address span. Store only the ~14% occupied buckets as packed
    # rows plus an 8-lane pointer array: probe = ptr-row gather (32 B
    # rows) + packed-row gather. Packed row 0 is a reserved all-empty
    # bucket that every empty slot points at. Dense direct is the default
    # (scripts/ab_engine_envs.py A/Bs the two: the dependent pointer gather
    # + lane select cost more than the smaller address span saved);
    # indirection stays available when device memory is tight (2.7 GB
    # -> 0.5 GB of tables on the 20k-allele library).
    indirect = os.environ.get("NIMBLE_TPU_GBAND_INDIRECT", "0") == "1"
    if indirect:
        occ_buckets = np.unique(b)
        n_rows = occ_buckets.shape[0] + 1
        ptr = np.zeros(nb2, dtype=np.int32)  # empty buckets -> row 0
        ptr[occ_buckets] = np.arange(1, n_rows, dtype=np.int32)
        rb = ptr[b]
        ptr8 = ptr.reshape(-1, 8)
    else:  # dense direct layout (one gather per probe)
        n_rows = nb2
        rb = b
        ptr8 = None
    # packed rows [hi S | lo S | w0 S | w1 S] when the half-row indices
    # fit 18 bits and g <= 6 (w0 = idx_s | vs<<18 | vd<<24, w1 = idx_d |
    # rvs<<18 | rvd<<24): 64 B rows instead of 80 B — ~20% less table
    # address span for the dominant probe gather. Wider configs keep the
    # 5-plane layout.
    n_band_rows = band_table.shape[0]
    packed_rows = n_band_rows < (1 << 18) and g <= 6
    if packed_rows:
        vs_m = mask_word & 0x3F
        vd_m = (mask_word >> 8) & 0x3F
        rvs_m = (mask_word >> 16) & 0x3F
        rvd_m = (mask_word >> 24) & 0x3F
        w0 = remap_s | (vs_m << 18) | (vd_m << 24)
        w1 = remap_d | (rvs_m << 18) | (rvd_m << 24)
        table = np.zeros((n_rows, S * 4), dtype=np.int32)
        table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
        table[rb, s] = hi[keys].view(np.int32)
        table[rb, S + s] = lo[keys].view(np.int32)
        table[rb, 2 * S + s] = w0[keys]
        table[rb, 3 * S + s] = w1[keys]
    else:
        table = np.zeros((n_rows, S * 5), dtype=np.int32)
        table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
        table[rb, s] = hi[keys].view(np.int32)
        table[rb, S + s] = lo[keys].view(np.int32)
        table[rb, 2 * S + s] = remap_s[keys]  # same-orientation half row
        table[rb, 3 * S + s] = remap_d[keys]  # diff-orientation half row
        table[rb, 4 * S + s] = mask_word[keys]

    n_stash = skeys.shape[0]
    pad = max(1, n_stash)
    gs_hi = np.full(pad, -1, dtype=np.int32)
    gs_lo = np.zeros(pad, dtype=np.int32)
    gs_idx_s = np.zeros(pad, dtype=np.int32)
    gs_idx_d = np.zeros(pad, dtype=np.int32)
    gs_mask = np.zeros(pad, dtype=np.int32)
    if n_stash:
        gs_hi[:n_stash] = hi[skeys].view(np.int32)
        gs_lo[:n_stash] = lo[skeys].view(np.int32)
        gs_idx_s[:n_stash] = remap_s[skeys]
        gs_idx_d[:n_stash] = remap_d[skeys]
        gs_mask[:n_stash] = mask_word[skeys]
    out = {
        "gband_bucket": jnp.asarray(table),
        **({"gband_ptr8": jnp.asarray(ptr8)} if ptr8 is not None else {}),
        "gband_table": jnp.asarray(band_table),
        "gband_stash_hi": jnp.asarray(gs_hi),
        "gband_stash_lo": jnp.asarray(gs_lo),
        "gband_stash_idx_s": jnp.asarray(gs_idx_s),
        "gband_stash_idx_d": jnp.asarray(gs_idx_d),
        "gband_stash_mask": jnp.asarray(gs_mask),
    }
    if not two_choice:
        # trace-time marker: probe only h1 (key never lives elsewhere)
        out["gband_single"] = jnp.zeros((1,), jnp.int32)
    if packed_rows:
        out["gband_packedrow"] = jnp.zeros((1,), jnp.int32)
    cache[mode_key] = out
    if disk:
        try:
            tmp = disk + ".tmp.npz"
            np.savez(
                tmp,
                __fp=_fingerprint(),
                **{k: np.asarray(v) for k, v in out.items()},
            )
            os.replace(tmp, disk)
        except Exception:
            pass  # cache write is best-effort
    return out


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


# packed-output columns after the W bits words: scores ship as uint16
# halves (score <= 2*max_len << 65536; the engines guard max_len <= 16383)
# so the D2H wire cost is W+3 int32 per read instead of W+6
PACKED_EXTRA = 3
MAX_LEN_LIMIT = 16383  # keeps every score strictly inside a uint16 half


def pack_outputs(out: dict) -> jnp.ndarray:
    """align_step outputs -> ONE flat int32 array, row-major (B, W+3):
    bits | score|r1_fwd<<16 | r1_rev|r2_fwd<<16 | r2_rev|pass_<<16.
    Each transfer has a fixed per-array cost, so the dispatch path ships a
    single array per call (unpack: unpack_outputs)."""
    s = {k: out[k].astype(jnp.int32) for k in ("score", "r1_fwd", "r1_rev", "r2_fwd", "r2_rev")}
    c0 = s["score"] | (s["r1_fwd"] << 16)
    c1 = s["r1_rev"] | (s["r2_fwd"] << 16)
    c2 = s["r2_rev"] | (out["pass_"].astype(jnp.int32) << 16)
    cols = [out["bits"], c0[:, None], c1[:, None], c2[:, None]]
    return jnp.concatenate(cols, axis=1).reshape(-1)


def unpack_outputs(flat: np.ndarray, W: int, valid: int) -> dict:
    """Host-side inverse of pack_outputs, sliced to the valid row count."""
    arr = flat.reshape(-1, W + PACKED_EXTRA)[:valid]
    lo = lambda c: arr[:, W + c] & 0xFFFF
    hi = lambda c: (arr[:, W + c] >> 16) & 0xFFFF
    return {
        "bits": arr[:, :W],
        "score": lo(0),
        "r1_fwd": hi(0),
        "r1_rev": lo(1),
        "r2_fwd": hi(1),
        "r2_rev": lo(2),
        "pass_": (hi(2) & 1).astype(bool),
    }


# bump to invalidate persisted .gband sidecar caches on layout changes
GBAND_FORMAT_VERSION = 3  # v3: 16-int packed probe rows (idx|masks words)


class CompactOverflow(Exception):
    """Compact-output spill buffer overflowed; rerun the span full-format."""


def compact_chunk_len(C: int, W: int, H: int, SP: int) -> int:
    """Flat int32 length of one compact-format chunk."""
    return 2 * C + H * W + SP * (W + 1) + 8


def pack_outputs_compact(out: dict, H: int, SP: int) -> jnp.ndarray:
    """Dictionary-compacted wire format for align_step outputs.

    Distinct result bitsets per chunk are few (intersections of library
    equivalence classes), so per read we ship 2 int32:

      w0 = score | r1_fwd<<16
      w1 = slot | r2_fwd<<14 | pass_<<28 | miss<<29

    plus a per-chunk slot dictionary (H x W: two-choice placed bitsets)
    and a spill buffer (SP x (1+W): row id + bitset) for rows whose bitset
    lost both candidate slots. w1 layout (fixed, independent of H):
    slot = bits 0..13 (so H <= 16384), r2_fwd = bits 14..27, pass = 28,
    miss = 29. Non-pass rows are excluded from the dictionary (their bits
    reconstruct as zeros; emission masks them and the short-read patch
    overwrites them). Exact: the host reconstructs a bit-identical `bits`
    matrix, or raises CompactOverflow when spill > SP (collect_async then
    reruns that span in the full format). rev scores are not shipped (no
    downstream consumer; unpack returns zeros).

    Sizing: a 1%-error 100bp workload shows ~11k distinct bitsets per 64k
    reads (mostly singleton error-window intersections), so single-choice
    placement at H=4096 spilled ~14k rows/chunk; two-choice at H=16384
    keeps spill in the hundreds.
    """
    bits = out["bits"]
    C, W = bits.shape
    score = out["score"].astype(jnp.int32)
    f1 = out["r1_fwd"].astype(jnp.int32)
    f2 = out["r2_fwd"].astype(jnp.int32)
    pass_ = out["pass_"].astype(jnp.int32)
    is_pass = pass_ == 1

    def mix(seed):
        h = jnp.full((C,), jnp.int32(seed))
        for wi in range(W):
            h = (h ^ bits[:, wi]) * jnp.int32(-1640531527)
            h = h ^ jax.lax.shift_right_logical(h, 15)
        return h & jnp.int32(H - 1)

    def rows_equal(a):
        eq = a == bits
        m = eq[:, 0]
        for wi in range(1, W):
            m = m & eq[:, wi]
        return m

    h1 = mix(0)
    h2 = mix(0x2545F491)
    table = (
        jnp.zeros((H, W), jnp.int32)
        .at[jnp.where(is_pass, h1, jnp.int32(H))]
        .set(bits, mode="drop")
    )
    occ = (
        jnp.zeros((H,), jnp.int32)
        .at[jnp.where(is_pass, h1, jnp.int32(H))]
        .set(1, mode="drop")
    )
    m1 = rows_equal(table[h1])
    cand2 = is_pass & ~m1 & (occ[h2] == 0)
    table = table.at[jnp.where(cand2, h2, jnp.int32(H))].set(bits, mode="drop")
    m2 = rows_equal(table[h2])
    use2 = ~m1 & m2
    slot = jnp.where(use2, h2, h1)
    miss = is_pass & ~(m1 | m2)
    miss_i = miss.astype(jnp.int32)
    pos = jnp.cumsum(miss_i) - 1
    sidx = jnp.where(miss & (pos < SP), pos, jnp.int32(SP))
    rowid = jnp.arange(C, dtype=jnp.int32)
    spill_vals = jnp.concatenate([rowid[:, None], bits], axis=1)
    spill = (
        jnp.zeros((SP, W + 1), jnp.int32).at[sidx].set(spill_vals, mode="drop")
    )
    counters = jnp.zeros((8,), jnp.int32).at[0].set(jnp.sum(miss_i))
    w0 = score | (f1 << 16)
    w1 = slot | (f2 << 14) | (pass_ << 28) | (miss_i << 29)
    per_read = jnp.stack([w0, w1], axis=1).reshape(-1)
    return jnp.concatenate(
        [per_read, table.reshape(-1), spill.reshape(-1), counters]
    )


def _popcount32_rows(words: jnp.ndarray) -> jnp.ndarray:
    """(B, W) int32 -> (B,) total set-bit count (feature-set size)."""
    x = words
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0x3F).sum(axis=1)


def compress_band_rows(bits: jnp.ndarray, Pw: int) -> jnp.ndarray:
    """(B, W) expanded bitsets -> (B, 1+2*Pw) banded rows [page | band],
    exact for any bitset whose nonzero words span <= 2 consecutive pages
    anchored at the first nonzero page. Every gband result qualifies: a
    single mate's bits are one expanded band, and every paired combination
    except the intersect_level=1 union fallback is an AND of bands (ANDs
    stay within either operand's span). Used by the banded wire codec —
    W=625 full rows would be 2.5 KB/read."""
    B, W = bits.shape
    n_pages = -(-W // Pw)
    bp = jnp.pad(bits, ((0, 0), (0, (n_pages + 1) * Pw - W)))
    page_has = jnp.any(
        bp[:, : n_pages * Pw].reshape(B, n_pages, Pw) != 0, axis=2
    )
    page = jnp.argmax(page_has, axis=1).astype(jnp.int32)  # first nonzero
    band = jnp.zeros((B, 2 * Pw), dtype=jnp.int32)
    for pg in range(n_pages):
        band = jnp.where(
            (page == pg)[:, None], bp[:, pg * Pw : (pg + 2) * Pw], band
        )
    return jnp.concatenate([page[:, None], band], axis=1)


def expand_band_rows_np(rows: np.ndarray, Pw: int, W: int) -> np.ndarray:
    """Host inverse of compress_band_rows: (N, 1+2*Pw) -> (N, W)."""
    n = rows.shape[0]
    n_pages = -(-W // Pw)
    out = np.zeros((n, (n_pages + 1) * Pw), dtype=np.int32)
    page = rows[:, 0]
    cols = page[:, None] * Pw + np.arange(2 * Pw)[None, :]
    np.put_along_axis(out, cols, rows[:, 1:], axis=1)
    return out[:, :W]


def pack_outputs_idlist(
    out: dict, cap: int, Pw: int, packed16: bool = False,
    hdr1: bool = False,
) -> jnp.ndarray:
    """Wide-W emission wire for emit-cap engines: per read
    [w0 = score | r1_fwd<<16, w1 = r2_fwd<<14 | pass_<<28, id0..id{cap-1}]
    — the class's feature ids directly (-1 padded; all -1 for non-pass
    rows), flattened to (C*(2+cap),) int32.

    packed16 (engines with n_features <= 32767): ids ship as int16 pairs
    packed two per word (absent = 0xFFFF sentinel), ceil(cap/2) words —
    48 -> 28 B/read at cap=10.

    hdr1 (engines with 2*max_len <= 1023, i.e. reads <= 511 bp): the two
    header words collapse into one —
    w = score | r1_fwd<<10 | r2_fwd<<19 | pass_<<28 — score fits 10 bits
    (paired sum <= 2*max_len) and each forward score 9 bits (<= max_len).
    With packed16 at cap=10 this is 24 B/read (1 + 5 words).

    Replaces the band-row + per-chunk-dictionary codec when the device
    emission cap is active: every surviving class has <= cap features by
    construction, so cap+2 words/read (48 B at cap=10) beats the
    dictionary's fixed H*(1+2Pw) words/chunk (~200 B/read at W=625) AND
    removes the spill-overflow full-format path entirely. Host emission
    resolves feature names straight from the ids
    (pipeline.resolve_features_ids): no bitset decode at all.

    Extraction: every surviving class has <= cap set bits (the emission
    cap ran first), so its id list is exactly the top-cap of
    "band-bit position where set, else -1" — one fused lax.top_k over the
    expanded band, no scatters (a 64-step scatter loop serializes). On
    the H100 XLA lowers this top_k to a sort that takes most of the wide
    step's device time (PERF.md, "Where the time goes")."""
    bits = out["bits"]
    C, W = bits.shape
    band = out.get("_band")
    if band is None:
        band = compress_band_rows(bits, Pw)
    page = band[:, 0]
    is_pass = out["pass_"].astype(jnp.int32) == 1
    base = page * (Pw * 32)
    shifts = jnp.arange(32, dtype=jnp.int32)
    nb = 2 * Pw
    pos = (
        jnp.arange(nb, dtype=jnp.int32)[None, :, None] * 32
        + shifts[None, None, :]
    )  # (1, nb, 32) band-bit positions
    b = (band[:, 1:, None] >> shifts[None, None, :]) & 1  # (C, nb, 32)
    vals = jnp.where(b == 1, pos, jnp.int32(-1)).reshape(C, nb * 32)
    top, _ = jax.lax.top_k(vals, cap)  # (C, cap), descending positions
    ids = jnp.where(
        (top >= 0) & is_pass[:, None], base[:, None] + top, jnp.int32(-1)
    )
    score = out["score"].astype(jnp.int32)
    f1 = out["r1_fwd"].astype(jnp.int32)
    f2 = out["r2_fwd"].astype(jnp.int32)
    pass_ = out["pass_"].astype(jnp.int32)
    if hdr1:
        hdr = jnp.stack(
            [score | (f1 << 10) | (f2 << 19) | (pass_ << 28)], axis=1
        )
    else:
        w0 = score | (f1 << 16)
        w1 = (f2 << 14) | (pass_ << 28)
        hdr = jnp.stack([w0, w1], axis=1)
    if packed16:
        idu = jnp.where(ids >= 0, ids, jnp.int32(0xFFFF))
        if cap & 1:
            idu = jnp.concatenate(
                [idu, jnp.full((C, 1), jnp.int32(0xFFFF))], axis=1
            )
        ids = idu[:, 0::2] | (idu[:, 1::2] << 16)
    return jnp.concatenate([hdr, ids], axis=1).reshape(-1)


def unpack_outputs_idlist(
    flat: np.ndarray, C: int, cap: int, valid: int, packed16: bool = False,
    hdr1: bool = False,
) -> dict:
    """Host inverse of pack_outputs_idlist over S stacked chunks."""
    nh = 1 if hdr1 else 2
    row_w = nh + (((cap + 1) // 2) if packed16 else cap)
    if flat.size % (C * row_w) != 0:
        raise ValueError(
            f"payload size {flat.size} not a multiple of idlist chunk "
            f"length {C * row_w} (C={C}, cap={cap}, packed16={packed16}, "
            f"hdr1={hdr1})"
        )
    rows = flat.reshape(-1, row_w)
    ids = rows[:, nh:][:valid]
    if packed16:
        n = ids.shape[0]
        un = np.empty((n, 2 * ids.shape[1]), dtype=np.int32)
        un[:, 0::2] = ids & 0xFFFF
        un[:, 1::2] = (ids >> 16) & 0xFFFF
        un[un == 0xFFFF] = -1
        ids = un[:, :cap]
    if hdr1:
        w = rows[:, 0]
        return {
            "ids": ids,
            "score": (w & 0x3FF)[:valid],
            "r1_fwd": ((w >> 10) & 0x1FF)[:valid],
            "r1_rev": np.zeros(valid, np.int32),
            "r2_fwd": ((w >> 19) & 0x1FF)[:valid],
            "r2_rev": np.zeros(valid, np.int32),
            "pass_": ((w >> 28) & 1)[:valid],
        }
    w0 = rows[:, 0]
    w1 = rows[:, 1]
    return {
        "ids": ids,
        "score": (w0 & 0xFFFF)[:valid],
        "r1_fwd": ((w0 >> 16) & 0xFFFF)[:valid],
        "r1_rev": np.zeros(valid, np.int32),
        "r2_fwd": ((w1 >> 14) & 0x3FFF)[:valid],
        "r2_rev": np.zeros(valid, np.int32),
        "pass_": ((w1 >> 28) & 1)[:valid],
    }


def ids_to_bits_np(ids: np.ndarray, W: int) -> np.ndarray:
    """(n, cap) feature-id rows (-1 padded) -> dense (n, W) int32 bitsets
    (the rare densify path: short-read patching on an idlist span)."""
    n = ids.shape[0]
    bits = np.zeros((n, W * 32), dtype=np.uint8)
    rows, _ = np.nonzero(ids >= 0)
    vals = ids[ids >= 0]
    bits[rows, vals] = 1
    packed = np.packbits(bits.reshape(n, W, 32), axis=2, bitorder="little")
    return packed.view("<u4").reshape(n, W).astype(np.int32)


def compress_band_rows_np(bits: np.ndarray, Pw: int) -> np.ndarray:
    """Host mirror of compress_band_rows for dense (N, W) rows — used to
    keep the rare full-format overflow fallback in the same band-row form
    the no-expand collect path hands to emission. Exact under the same
    2-consecutive-page condition (always true for gband results)."""
    n, W = bits.shape
    n_pages = -(-W // Pw)
    bp = np.zeros((n, (n_pages + 1) * Pw), dtype=np.int32)
    bp[:, :W] = bits
    page_has = bp[:, : n_pages * Pw].reshape(n, n_pages, Pw).any(axis=2)
    page = np.where(
        page_has.any(axis=1), page_has.argmax(axis=1), 0
    ).astype(np.int32)
    idx = page[:, None] * Pw + np.arange(2 * Pw)[None, :]
    band = np.take_along_axis(bp, idx, axis=1)
    return np.concatenate([page[:, None], band], axis=1)


def unpack_outputs_compact(
    flat: np.ndarray, C: int, H: int, SP: int, valid: int,
    W: Optional[int] = None,
) -> dict:
    """Host-side inverse of pack_outputs_compact over S stacked chunks.

    Pass W (the engine's static bits width) whenever known — size-based
    inference can misparse when one width's chunk length divides another
    width's payload. Inference remains only for W=None callers."""
    if W is not None:
        L = compact_chunk_len(C, W, H, SP)
        if flat.size % L != 0:
            raise ValueError(
                f"payload size {flat.size} not a multiple of compact chunk "
                f"length {L} (C={C}, W={W}, H={H}, SP={SP})"
            )
        S = flat.size // L
    else:
        # W determined by smallest-size match; ambiguous combinations
        # exist, which is why engine callers pass W explicitly
        W = S = 0
        for w in range(2, GROUP_MAX_WORDS + 1):
            L = compact_chunk_len(C, w, H, SP)
            if flat.size % L == 0:
                W, S = w, flat.size // L
                break
        if W == 0:
            raise ValueError("not a compact-format payload")
    arr = flat.reshape(S, compact_chunk_len(C, W, H, SP))
    bits = np.zeros((S * C, W), np.int32)
    score = np.empty(S * C, np.int32)
    f1 = np.empty(S * C, np.int32)
    f2 = np.empty(S * C, np.int32)
    pas = np.empty(S * C, np.int32)
    for s in range(S):
        a = arr[s]
        pr = a[: 2 * C].reshape(C, 2)
        table = a[2 * C : 2 * C + H * W].reshape(H, W)
        spill = a[2 * C + H * W : 2 * C + H * W + SP * (W + 1)].reshape(
            SP, W + 1
        )
        n_spill = int(a[-8])
        if n_spill > SP:
            raise CompactOverflow(f"{n_spill} spill rows > cap {SP}")
        w0 = pr[:, 0]
        w1 = pr[:, 1]
        lo, hi = s * C, (s + 1) * C
        score[lo:hi] = w0 & 0xFFFF
        f1[lo:hi] = (w0 >> 16) & 0xFFFF
        f2[lo:hi] = (w1 >> 14) & 0x3FFF
        p = (w1 >> 28) & 1
        pas[lo:hi] = p
        b = table[w1 & 0x3FFF]
        b[p == 0] = 0
        if n_spill:
            b[spill[:n_spill, 0]] = spill[:n_spill, 1:]
        bits[lo:hi] = b
    zeros = np.zeros(valid, np.int32)
    return {
        "bits": bits[:valid],
        "score": score[:valid],
        "r1_fwd": f1[:valid],
        "r1_rev": zeros,
        "r2_fwd": f2[:valid],
        "r2_rev": zeros.copy(),
        "pass_": pas[:valid].astype(bool),
    }


def unpack_reads(words: jnp.ndarray, L: int, nflags: Optional[jnp.ndarray] = None):
    """Device-side inverse of io.packing.pack_codes: (B, ceil(L/16)) int32
    packed words -> (B, L) int8 base codes, restoring N_CODE at flagged
    positions. Pure elementwise shift/mask work (no gathers)."""
    B, Lw = words.shape
    rep = jnp.broadcast_to(words[:, :, None], (B, Lw, 16)).reshape(B, Lw * 16)[:, :L]
    sh = jnp.asarray((2 * (np.arange(L) % 16)).astype(np.int32))
    codes = ((rep >> sh[None, :]) & 3).astype(jnp.int8)
    if nflags is not None:
        Lf = nflags.shape[1]
        nrep = jnp.broadcast_to(nflags[:, :, None], (B, Lf, 32)).reshape(B, Lf * 32)[
            :, :L
        ]
        nsh = jnp.asarray((np.arange(L) % 32).astype(np.int32))
        isn = ((nrep >> nsh[None, :]) & 1) != 0
        codes = jnp.where(isn, jnp.int8(N_CODE), codes)
    return codes


def scatter_nflags(n_idx: jnp.ndarray, n_rows: jnp.ndarray, B: int) -> jnp.ndarray:
    """Sparse N sidecar -> dense (B, Lf) flag plane. Padding entries carry
    n_idx >= B and are dropped by the scatter."""
    Lf = n_rows.shape[1]
    return (
        jnp.zeros((B, Lf), jnp.int32).at[n_idx].set(n_rows, mode="drop")
    )


def _to_host(v) -> np.ndarray:
    """Device -> host transfer. 2D outputs are flattened on device first,
    so the copy never goes through a host-side relayout of a tiled 2D
    layout."""
    if v.ndim >= 2:
        flat = np.asarray(jnp.reshape(v, (-1,)))
        return flat.reshape(v.shape)
    return np.asarray(v)


def kmer_hi_lo(codes: jnp.ndarray, lens: jnp.ndarray, k: int):
    """(B, L) int8 base codes -> k-mer (hi, lo) uint32 codes at each of
    P = L-k+1 positions, plus validity. Bit layout: first base in the high
    bits; 2-bit positions are even so no base straddles the hi/lo boundary."""
    B, L = codes.shape
    P = L - k + 1
    assert P >= 1, "reads shorter than k"
    c = codes.astype(jnp.uint32)
    hi = jnp.zeros((B, P), dtype=jnp.uint32)
    lo = jnp.zeros((B, P), dtype=jnp.uint32)
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        window = c[:, j : j + P] & jnp.uint32(3)
        if bitpos >= 32:
            hi = hi | (window << jnp.uint32(bitpos - 32))
        else:
            lo = lo | (window << jnp.uint32(bitpos))
    bad = (codes == N_CODE).astype(jnp.int32)
    bad_cum = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=jnp.int32), jnp.cumsum(bad, axis=1)], axis=1
    )
    no_n = (bad_cum[:, k:] - bad_cum[:, :-k]) == 0
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    inside = pos + k <= lens[:, None]
    return hi, lo, no_n & inside


def revcomp_hi_lo(hi, lo, k: int):
    """Elementwise reverse-complement of packed 2k-bit k-mer codes held as
    (hi, lo) uint32 pairs — pure elementwise bit-twiddling, no gathers.

    Conceptually: complement all 64 bits, reverse 2-bit groups across the
    64-bit word, shift right by 64-2k; garbage from the unused high bits
    lands in the discarded low bits."""

    def rev2_32(y):
        y = ((y & jnp.uint32(0x33333333)) << jnp.uint32(2)) | (
            (y >> jnp.uint32(2)) & jnp.uint32(0x33333333)
        )
        y = ((y & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)) | (
            (y >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F)
        )
        y = ((y & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)) | (
            (y >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF)
        )
        return (y << jnp.uint32(16)) | (y >> jnp.uint32(16))

    nh = rev2_32(~lo)  # reversed 64-bit: high word comes from lo
    nl = rev2_32(~hi)
    s = 64 - 2 * k
    if s >= 32:
        out_lo = nh >> jnp.uint32(s - 32) if s > 32 else nh
        out_hi = jnp.zeros_like(nh)
    else:
        out_lo = (nl >> jnp.uint32(s)) | (nh << jnp.uint32(32 - s))
        out_hi = nh >> jnp.uint32(s)
    if 2 * k > 32:
        out_hi = out_hi & jnp.uint32((1 << (2 * k - 32)) - 1)
    else:
        out_hi = jnp.zeros_like(out_hi)
        out_lo = out_lo & jnp.uint32((1 << (2 * k)) - 1) if 2 * k < 32 else out_lo
    return out_hi, out_lo


def _canonical_keys(hi, lo, k: int):
    """Forward codes -> (canonical hi/lo, fwd_is_canon, palindrome)."""
    rc_hi, rc_lo = revcomp_hi_lo(hi, lo, k)
    fwd_is_canon = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
    palindrome = (hi == rc_hi) & (lo == rc_lo)
    c_hi = jnp.where(fwd_is_canon, hi, rc_hi)
    c_lo = jnp.where(fwd_is_canon, lo, rc_lo)
    return c_hi, c_lo, fwd_is_canon, palindrome


def window_keys(codes, lens, k: int, n_buckets: int):
    """The window stage: rolling 2-bit pack, reverse complement, canonical
    choice, validity and both bucket hashes, as one elementwise chain for
    XLA to fuse. codes (B, L) int8, lens (B,) int32 -> (c_hi, c_lo [int32
    bitcast], h1, h2 [int32], fwd_canon, palindrome, valid [bool]), each
    (B, L-k+1)."""
    with jax.named_scope("window"):
        hi, lo, valid = kmer_hi_lo(codes, lens, k)
        c_hi, c_lo, fwd_c, palin = _canonical_keys(hi, lo, k)
        h1, h2 = bucket_hashes_jnp(c_hi, c_lo, n_buckets)
        return (
            _bitcast_i32(c_hi), _bitcast_i32(c_lo),
            h1.astype(jnp.int32), h2.astype(jnp.int32),
            fwd_c, palin, valid,
        )


def lookup_classes(hi, lo, valid, tables, n_buckets: int, k: int):
    """Canonical two-choice probe answering BOTH read orientations at once.

    (hi, lo) are FORWARD k-mer codes; the canonical code probes the table
    whose entries carry (val_same, val_diff). Returns (cls_fwd, cls_rev)
    int32 class ids (-1 miss): cls_fwd for the read's forward strand,
    cls_rev for its reverse complement."""
    c_hi, c_lo, fwd_is_canon, palindrome = _canonical_keys(hi, lo, k)

    h1, h2 = bucket_hashes_jnp(c_hi, c_lo, n_buckets)
    hi_i = _bitcast_i32(c_hi)
    lo_i = _bitcast_i32(c_lo)
    S = BUCKET_SLOTS
    vs = jnp.full(hi.shape, -1, dtype=jnp.int32)
    vd = jnp.full(hi.shape, -1, dtype=jnp.int32)
    for h in (h1, h2):
        row = tables["bucket"][h.astype(jnp.int32)]  # (B, P, 4S)
        bk_hi = row[..., 0:S]
        bk_lo = row[..., S : 2 * S]
        bk_vs = row[..., 2 * S : 3 * S]
        bk_vd = row[..., 3 * S : 4 * S]
        match = (bk_hi == hi_i[..., None]) & (bk_lo == lo_i[..., None]) & (
            (bk_vs >= 0) | (bk_vd >= 0)
        )
        # at most one slot matches (keys are unique): max-select it
        vs = jnp.maximum(vs, jnp.max(jnp.where(match, bk_vs, -1), axis=-1))
        vd = jnp.maximum(vd, jnp.max(jnp.where(match, bk_vd, -1), axis=-1))
    for s in range(STASH_SIZE):
        match = (tables["stash_hi"][s] == hi_i) & (tables["stash_lo"][s] == lo_i) & (
            (tables["stash_vsame"][s] >= 0) | (tables["stash_vdiff"][s] >= 0)
        )
        vs = jnp.where(match, tables["stash_vsame"][s], vs)
        vd = jnp.where(match, tables["stash_vdiff"][s], vd)

    cls_fwd = jnp.where(fwd_is_canon, vs, vd)
    cls_rev = jnp.where(palindrome, vs, jnp.where(fwd_is_canon, vd, vs))
    cls_fwd = jnp.where(valid, cls_fwd, -1)
    cls_rev = jnp.where(valid, cls_rev, -1)
    return cls_fwd, cls_rev


def lookup_inline_bits(hi, lo, valid, tables, n_buckets: int, k: int, W: int):
    """Canonical two-choice probe with INLINED class bitsets: one bucket-row
    gather per hash candidate yields keys AND both orientations' feature
    bitsets — no separate class-table gather. Returns
    (bits_fwd, bits_rev) as (B, P, W) int32 (all-zero = miss)."""
    c_hi, c_lo, fwd_is_canon, palindrome = _canonical_keys(hi, lo, k)
    h1, h2 = bucket_hashes_jnp(c_hi, c_lo, n_buckets)
    hi_i = _bitcast_i32(c_hi)
    lo_i = _bitcast_i32(c_lo)
    S = BUCKET_SLOTS
    B, P = hi.shape
    vs_bits = jnp.zeros((B, P, W), dtype=jnp.int32)
    vd_bits = jnp.zeros((B, P, W), dtype=jnp.int32)
    for h in (h1, h2):
        row = tables["bucket"][h.astype(jnp.int32)]  # (B, P, width)
        bk_hi = row[..., 0:S]
        bk_lo = row[..., S : 2 * S]
        vsb = row[..., 4 * S : 4 * S + S * W].reshape(B, P, S, W)
        vdb = row[..., 4 * S + S * W :].reshape(B, P, S, W)
        occupied = jnp.any((vsb | vdb) != 0, axis=-1)  # (B, P, S)
        match = (bk_hi == hi_i[..., None]) & (bk_lo == lo_i[..., None]) & occupied
        # at most one slot matches: OR-select it
        sel = match[..., None]
        vs_bits = vs_bits | jnp.where(sel, vsb, 0).sum(axis=2)
        vd_bits = vd_bits | jnp.where(sel, vdb, 0).sum(axis=2)
    for s in range(STASH_SIZE):
        # empty stash rows carry all-zero bitsets, so a spurious key match
        # against an empty row contributes nothing
        match = (tables["stash_hi"][s] == hi_i) & (tables["stash_lo"][s] == lo_i)
        vs_bits = vs_bits | jnp.where(match[..., None], tables["stash_vs_bits"][s], 0)
        vd_bits = vd_bits | jnp.where(match[..., None], tables["stash_vd_bits"][s], 0)

    bits_f = jnp.where(fwd_is_canon[..., None], vs_bits, vd_bits)
    alt = jnp.where(fwd_is_canon[..., None], vd_bits, vs_bits)
    bits_r = jnp.where(palindrome[..., None], vs_bits, alt)
    v = valid[..., None]
    return jnp.where(v, bits_f, 0), jnp.where(v, bits_r, 0)


def lookup_mono_bits(hi, lo, valid, tables, k: int, W: int):
    """Single-hash probe: ONE bucket-row gather per window answers keys and
    both orientations' bitsets; overflow keys live in a vector-swept stash.
    Returns (bits_fwd, bits_rev) as (B, P, W) int32 (all-zero = miss)."""
    c_hi, c_lo, fwd_is_canon, palindrome = _canonical_keys(hi, lo, k)
    nb2 = tables["mono_bucket"].shape[0]
    h1, _ = bucket_hashes_jnp(c_hi, c_lo, nb2)
    return mono_probe(
        _bitcast_i32(c_hi),
        _bitcast_i32(c_lo),
        h1,
        fwd_is_canon,
        palindrome,
        valid,
        tables,
        W,
    )


def mono_probe(hi_i, lo_i, h1, fwd_is_canon, palindrome, valid, tables, W: int):
    """Mono-table probe from precomputed canonical keys: hi_i/lo_i int32
    bitcast canonical codes, h1 the mono bucket hash, plus orientation/
    validity masks (all (B, P)). Returns (bits_fwd, bits_rev)."""
    B, P = hi_i.shape

    # slots per bucket derived from the row width (stacked tables use
    # narrower buckets than the single-library MONO_SLOTS layout)
    S = tables["mono_bucket"].shape[1] // (2 + 2 * W)
    row = tables["mono_bucket"][h1.astype(jnp.int32)]  # (B, P, S*entry)
    # planar layout: every slice below is contiguous in the gathered row
    bk_hi = row[..., 0:S]
    bk_lo = row[..., S : 2 * S]
    vsb = row[..., 2 * S : 2 * S + W * S].reshape(B, P, W, S)
    vdb = row[..., 2 * S + W * S :].reshape(B, P, W, S)
    # empty slots hold the impossible key hi = -1 (canonical hi < 2^30),
    # so a bare key compare suffices — no occupancy plane to read
    match = (bk_hi == hi_i[..., None]) & (bk_lo == lo_i[..., None])
    sel = match[:, :, None, :]  # (B, P, 1, S)
    # at most one slot matches (keys unique): sum-select it
    vs_bits = jnp.where(sel, vsb, 0).sum(axis=3)
    vd_bits = jnp.where(sel, vdb, 0).sum(axis=3)

    n_stash = tables["mono_stash_hi"].shape[0]
    for s in range(n_stash):
        m = (tables["mono_stash_hi"][s] == hi_i) & (tables["mono_stash_lo"][s] == lo_i)
        vs_bits = vs_bits | jnp.where(m[..., None], tables["mono_stash_vs_bits"][s], 0)
        vd_bits = vd_bits | jnp.where(m[..., None], tables["mono_stash_vd_bits"][s], 0)

    bits_f = jnp.where(fwd_is_canon[..., None], vs_bits, vd_bits)
    alt = jnp.where(fwd_is_canon[..., None], vd_bits, vs_bits)
    bits_r = jnp.where(palindrome[..., None], vs_bits, alt)
    v = valid[..., None]
    return jnp.where(v, bits_f, 0), jnp.where(v, bits_r, 0)


def lookup_monocls(hi, lo, valid, tables, k: int):
    """Wide-W single-hash probe: ONE row gather per window answers both
    orientations' CLASS IDS (bitsets resolved later by the runs-compacted
    intersection). Returns (cls_fwd, cls_rev) int32, -1 = miss."""
    c_hi, c_lo, fwd_is_canon, palindrome = _canonical_keys(hi, lo, k)
    nb2 = tables["mcls_bucket"].shape[0]
    h1, _ = bucket_hashes_jnp(c_hi, c_lo, nb2)
    hi_i = _bitcast_i32(c_hi)
    lo_i = _bitcast_i32(c_lo)
    S = tables["mcls_bucket"].shape[1] // 4
    row = tables["mcls_bucket"][h1.astype(jnp.int32)]  # (B, P, 4S)
    bk_hi = row[..., 0:S]
    bk_lo = row[..., S : 2 * S]
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (bk_hi == hi_i[..., None]) & (bk_lo == lo_i[..., None])
    # at most one slot matches (keys unique): max-select it (miss -> -1)
    vs = jnp.max(jnp.where(match, row[..., 2 * S : 3 * S], -1), axis=-1)
    vd = jnp.max(jnp.where(match, row[..., 3 * S : 4 * S], -1), axis=-1)
    n_stash = tables["mcls_stash_hi"].shape[0]
    for s in range(n_stash):
        m = (tables["mcls_stash_hi"][s] == hi_i) & (
            tables["mcls_stash_lo"][s] == lo_i
        )
        vs = jnp.where(m, tables["mcls_stash_vs"][s], vs)
        vd = jnp.where(m, tables["mcls_stash_vd"][s], vd)
    cls_fwd = jnp.where(fwd_is_canon, vs, vd)
    cls_rev = jnp.where(palindrome, vs, jnp.where(fwd_is_canon, vd, vs))
    cls_fwd = jnp.where(valid, cls_fwd, -1)
    cls_rev = jnp.where(valid, cls_rev, -1)
    return cls_fwd, cls_rev


def group_probe(hi_i, lo_i, h1, fwd_c, valid, tables, W: int, g: int):
    """Group-table probe from precomputed canonical (k+g-1)-mer keys: ONE
    row gather per probe position answers g read windows in both
    orientations. Returns (and_f, mask_f, and_r, mask_r): the pre-ANDed
    feature bitset of the probe's matched windows, (B, Q, W) int32, and the
    g-bit per-window presence mask, (B, Q) int32, for the read's forward /
    reverse orientation (mask bit i = window at probe position + i matched;
    masks are in forward coordinates for both orientations).

    Orientation algebra: for canonical code X carrying (vs_and, vs_mask)
    over X's windows and (vd_and, vd_mask) over revcomp(X)'s: a read group
    F == X takes fwd from vs and rev from vd with the mask bit-reversed
    within g (window i's reverse complement is revcomp(X)'s window g-1-i);
    F == revcomp(X) swaps the roles. Palindromic groups (possible when
    k+g-1 is even) need no special case: vs == vd there."""
    B, Q = hi_i.shape
    S = tables["group_bucket"].shape[1] // (2 + 2 * W + 1)
    row = tables["group_bucket"][h1.astype(jnp.int32)]  # (B, Q, S*entry)
    bk_hi = row[..., 0:S]
    bk_lo = row[..., S : 2 * S]
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (bk_hi == hi_i[..., None]) & (bk_lo == lo_i[..., None])
    sel = match[:, :, None, :]  # (B, Q, 1, S)
    vs_and = row[..., 2 * S : 2 * S + W * S].reshape(B, Q, W, S)
    vd_and = row[..., 2 * S + W * S : 2 * S + 2 * W * S].reshape(B, Q, W, S)
    # at most one slot matches (keys unique): sum-select it
    vs_and = jnp.where(sel, vs_and, 0).sum(axis=3)  # (B, Q, W)
    vd_and = jnp.where(sel, vd_and, 0).sum(axis=3)
    mword = jnp.where(match, row[..., 2 * S + 2 * W * S :], 0).sum(axis=2)  # (B, Q)
    n_stash = tables["group_stash_hi"].shape[0]
    for s in range(n_stash):
        m = (tables["group_stash_hi"][s] == hi_i) & (
            tables["group_stash_lo"][s] == lo_i
        )
        vs_and = vs_and | jnp.where(m[..., None], tables["group_stash_vs_and"][s], 0)
        vd_and = vd_and | jnp.where(m[..., None], tables["group_stash_vd_and"][s], 0)
        mword = mword | jnp.where(m, tables["group_stash_mask"][s], 0)

    gmask = jnp.int32((1 << g) - 1)
    fc = fwd_c[..., None]
    and_f = jnp.where(fc, vs_and, vd_and)
    and_r = jnp.where(fc, vd_and, vs_and)
    mask_f = jnp.where(fwd_c, mword, mword >> 8) & gmask
    mask_r = jnp.where(fwd_c, mword >> 24, mword >> 16) & gmask
    mask_f = jnp.where(valid, mask_f, 0)
    mask_r = jnp.where(valid, mask_r, 0)
    return and_f, mask_f, and_r, mask_r


def _score_mate_group(codes, lens, tables, p: "AlignParams"):
    """Group-probe scoring path: probe canonical (k+g-1)-mers on a stride-g
    grid (each answering g consecutive windows) plus ONE per-read tail probe
    at j* = len-(k+g-1) covering the read's last g windows — so every window
    a full-window mono probe would answer from library-resident groups is
    answered, and clean reads score bit-identically to the mono path.
    Divergences (all conservative, toward fewer matches): windows whose
    containing (k+g-1)-mer is broken by a read error/N lose up to g-1
    neighbor windows vs mono; reads shorter than k+g-1 bases are unmapped."""
    g = p.group_g
    kg = p.k + g - 1
    B, L = codes.shape
    P = L - p.k + 1  # k-windows
    PP = L - kg + 1  # group positions
    nb = tables["group_bucket"].shape[0]
    hi_i, lo_i, h1, _h2, fwd_c, _palin, valid = window_keys(codes, lens, kg, nb)

    # grid probes at 0, g, 2g, ... plus ONE per-read tail probe at the
    # data-dependent position j* = len-kg, appended as an extra column.
    # The tail operands are extracted with a one-hot masked sum (a (B, PP)
    # compare+reduce that fuses with the window stage) instead of a
    # per-read gather.
    jstar = jnp.clip(lens - kg, 0, PP - 1)
    onehot = jnp.arange(PP, dtype=jnp.int32)[None, :] == jstar[:, None]

    cat = []
    for a in (hi_i, lo_i, h1, fwd_c, valid):
        t = jnp.where(onehot, a.astype(jnp.int32), 0).sum(axis=1, keepdims=True)
        cat.append(jnp.concatenate([a[:, ::g], t.astype(a.dtype)], axis=1))
    W = tables["class_bits"].shape[1]
    and_f, mask_f, and_r, mask_r = group_probe(*cat, tables, W, g)
    Q = cat[0].shape[1] - 1

    score_f, score_r = coverage_score2(
        group_win_matched(mask_f, Q, g, P, jstar),
        group_win_matched(mask_r, Q, g, P, jstar),
        lens, p.k, L, 1,
    )
    # the AND-intersection is order-independent and each probe's windows are
    # pre-ANDed: feed the (B, Q+1, W) probe planes directly (grid + tail,
    # duplicated windows idempotent), gated on the probe's presence mask
    return _select_orientation(
        and_f, and_r, mask_f != 0, mask_r != 0, score_f, score_r, p
    )


def groupcls_probe(hi_i, lo_i, h1, fwd_c, valid, tables, g: int):
    """Wide-W group-table probe: one row gather per probe position answers g
    windows' CLASS IDS in both orientations. Returns
    (cls_f, cls_r, mask_f, mask_r): per-window class columns, (B, Q*g)
    int32 (-1 = miss; column q*g+i is the window at probe position + i, for
    both orientations in forward coordinates), plus the g-bit presence
    masks, (B, Q) int32, matching group_probe's mask semantics.

    Orientation algebra (see group_probe): a group F == canonical X takes
    forward window i from X's vs column i and reverse-orientation window i
    (forward coordinates) from vd column g-1-i; F == revcomp(X) swaps vs/vd."""
    B, Q = hi_i.shape
    entry_cols = 2 * g
    S = tables["groupcls_bucket"].shape[1] // (2 + entry_cols + 1)
    row = tables["groupcls_bucket"][h1.astype(jnp.int32)]  # (B, Q, S*entry)
    bk_hi = row[..., 0:S]
    bk_lo = row[..., S : 2 * S]
    # empty slots hold the impossible key hi = -1: no occupancy check needed
    match = (bk_hi == hi_i[..., None]) & (bk_lo == lo_i[..., None])
    sel = match[:, :, None, :]  # (B, Q, 1, S)
    cols = row[..., 2 * S : 2 * S + entry_cols * S].reshape(B, Q, entry_cols, S)
    # at most one slot matches (keys unique): max-select it (miss -> -1)
    vals = jnp.max(jnp.where(sel, cols, -1), axis=3)  # (B, Q, 2g)
    mword = jnp.where(match, row[..., 2 * S + entry_cols * S :], 0).sum(axis=2)
    n_stash = tables["groupcls_stash_hi"].shape[0]
    for s in range(n_stash):
        m = (tables["groupcls_stash_hi"][s] == hi_i) & (
            tables["groupcls_stash_lo"][s] == lo_i
        )
        vals = jnp.where(m[..., None], tables["groupcls_stash_cols"][s], vals)
        mword = mword | jnp.where(m, tables["groupcls_stash_mask"][s], 0)

    vs_cols = vals[..., :g]
    vd_cols = vals[..., g:]
    fc = fwd_c[..., None]
    cls_f = jnp.where(fc, vs_cols, vd_cols)  # (B, Q, g)
    cls_r = jnp.where(fc, vd_cols, vs_cols)[..., ::-1]  # reversed within g
    v = valid[..., None]
    cls_f = jnp.where(v, cls_f, -1).reshape(B, Q * g)
    cls_r = jnp.where(v, cls_r, -1).reshape(B, Q * g)
    gmask = jnp.int32((1 << g) - 1)
    mask_f = jnp.where(fwd_c, mword, mword >> 8) & gmask
    mask_r = jnp.where(fwd_c, mword >> 24, mword >> 16) & gmask
    mask_f = jnp.where(valid, mask_f, 0)
    mask_r = jnp.where(valid, mask_r, 0)
    return cls_f, cls_r, mask_f, mask_r


def _score_mate_groupcls(codes, lens, tables, p: "AlignParams"):
    """Wide-W group-probe scoring path: identical probe grid + tail scheme
    and score/mask semantics as _score_mate_group, but the probe yields
    per-window CLASS IDS and the intersection is the runs-compacted
    class-bits AND (intersect_class_bits). The orientation is selected
    BEFORE the intersection, so only one orientation's classes gather
    bitset rows. Same conservative divergences as the narrow group path
    (error-broken (k+g-1)-mers, reads shorter than k+g-1)."""
    g = p.group_g
    kg = p.k + g - 1
    B, L = codes.shape
    P = L - p.k + 1  # k-windows
    PP = L - kg + 1  # group positions
    nb = tables["groupcls_bucket"].shape[0]
    hi_i, lo_i, h1, _h2, fwd_c, _palin, valid = window_keys(codes, lens, kg, nb)

    # grid probes at 0, g, 2g, ... plus ONE per-read tail probe at
    # j* = len-kg (one-hot extraction; see _score_mate_group)
    jstar = jnp.clip(lens - kg, 0, PP - 1)
    onehot = jnp.arange(PP, dtype=jnp.int32)[None, :] == jstar[:, None]

    cat = []
    for a in (hi_i, lo_i, h1, fwd_c, valid):
        t = jnp.where(onehot, a.astype(jnp.int32), 0).sum(axis=1, keepdims=True)
        cat.append(jnp.concatenate([a[:, ::g], t.astype(a.dtype)], axis=1))
    cls_f, cls_r, mask_f, mask_r = groupcls_probe(*cat, tables, g)
    Q = cat[0].shape[1] - 1

    score_f, score_r = coverage_score2(
        group_win_matched(mask_f, Q, g, P, jstar),
        group_win_matched(mask_r, Q, g, P, jstar),
        lens, p.k, L, 1,
    )
    if p.strand_filter == "fiveprime":
        use_fwd = jnp.ones_like(score_f, dtype=bool)
    elif p.strand_filter == "threeprime":
        use_fwd = jnp.zeros_like(score_f, dtype=bool)
    else:  # unstranded: higher-scoring orientation, ties -> forward
        use_fwd = score_f >= score_r

    # the AND is order-independent and duplicate classes are idempotent, so
    # the (grid + tail) column stream feeds the runs intersection directly —
    # tail columns duplicating grid windows cost at most one extra run
    cls_sel = jnp.where(use_fwd[:, None], cls_f, cls_r)
    bits = intersect_class_bits(cls_sel, cls_sel >= 0, tables["class_bits"])
    score = jnp.where(use_fwd, score_f, score_r)
    return bits, score, score_f, score_r


def _band_combine(p1, b1, h1, p2, b2, h2, Pw: int):
    """Page-banded intersection combine (associative, commutative): bands
    sit at page-aligned offsets, so the relative shift is a whole number of
    pages and |shift| >= 2 means disjoint supports (empty intersection) —
    a 3-way select of statically shifted ANDs, no dynamic per-row gathers.
    (p, b, h): page offset (..,), band (.., Wb), has-contribution (..,)."""
    zeros = jnp.zeros_like(b1[..., :Pw])
    up1 = jnp.concatenate([b1[..., Pw:], zeros], axis=-1)
    up2 = jnp.concatenate([b2[..., Pw:], zeros], axis=-1)
    d = p2 - p1
    nb = jnp.where((d == 0)[..., None], b1 & b2, jnp.int32(0))
    nb = jnp.where((d == 1)[..., None], up1 & b2, nb)
    nb = jnp.where((d == -1)[..., None], b1 & up2, nb)
    both = h1 & h2
    band = jnp.where(both[..., None], nb, jnp.where(h1[..., None], b1, b2))
    page = jnp.where(both, jnp.maximum(p1, p2), jnp.where(h1, p1, p2))
    return page, band, h1 | h2


def _band_tree(page, band, has, Pw: int):
    """Halving-tree reduce of (B, n, ...) banded values over axis 1."""
    n = page.shape[1]
    while n > 1:
        half = n // 2
        pg, bd, hs = _band_combine(
            page[:, :half], band[:, :half], has[:, :half],
            page[:, half : 2 * half], band[:, half : 2 * half],
            has[:, half : 2 * half], Pw,
        )
        if n % 2:  # fold the odd leftover into slot 0 only
            p0, b0, h0 = _band_combine(
                pg[:, :1], bd[:, :1], hs[:, :1],
                page[:, -1:], band[:, -1:], has[:, -1:], Pw,
            )
            pg = pg.at[:, 0].set(p0[:, 0])
            bd = bd.at[:, 0].set(b0[:, 0])
            hs = hs.at[:, 0].set(h0[:, 0])
        page, band, has = pg, bd, hs
        n = half
    return page[:, 0], band[:, 0], has[:, 0]


def band_tree_expand(brow, has, W: int, Pw: int):
    """Banded intersection of a read's gathered band rows and its expansion
    to the full-width bitset: brow (B, n, 1+Wb) [page | band] rows, has
    (B, n) bool -> (B, W) int32 bits."""
    with jax.named_scope("band_tree"):
        pg, bd, hs = _band_tree(brow[..., 0], brow[..., 1:], has, Pw)
        return _expand_band(pg, bd, hs, W, Pw)


def _expand_band(page, band, has, W: int, Pw: int):
    """Banded -> full-width bitset: place each read's 2-page band at its
    page offset. Page p of the output holds the band's lower half when
    page == p and its upper half when page == p-1 — each output word is
    written exactly once (concat of independent per-page selects), no
    sequential in-place updates for XLA to materialize."""
    n_pages = -(-W // Pw) + 1
    lo, hi = band[:, :Pw], band[:, Pw:]
    parts = []
    for pg in range(n_pages):
        seg = jnp.where((page == pg)[:, None], lo, jnp.int32(0))
        if pg > 0:
            seg = seg | jnp.where((page == pg - 1)[:, None], hi, jnp.int32(0))
        parts.append(seg)
    out = jnp.concatenate(parts, axis=1)
    return jnp.where(has[:, None], out[:, :W], jnp.int32(0))


def _score_mate_groupband(codes, lens, tables, p: "AlignParams"):
    """Wide-W group-probe scoring with BANDED PRE-ANDED payloads: identical
    probe grid + tail scheme and mask/score semantics as _score_mate_group,
    but each probe position resolves to a page-banded 2-page bitset
    (gband_table HALF row) already holding the AND of its g windows'
    classes for ONE orientation. The probe row carries both orientations'
    half-row indices; use_fwd is decided from the probe masks alone
    (coverage scores need no bands), so only the selected orientation's
    half is ever gathered — half the band bytes and no per-position
    full-width orientation selects. Same conservative
    divergences as the narrow group path."""
    g = p.group_g
    kg = p.k + g - 1
    B, L = codes.shape
    P = L - p.k + 1
    PP = L - kg + 1
    indirect = "gband_ptr8" in tables
    nb = (
        tables["gband_ptr8"].shape[0] * 8
        if indirect
        else tables["gband_bucket"].shape[0]
    )
    W = tables["class_bits"].shape[1]
    Wb = tables["gband_table"].shape[1] - 1
    Pw = Wb // 2
    jstar = jnp.clip(lens - kg, 0, PP - 1)
    # stride FIRST: the rolling (hi, lo) build is cheap shift/or work;
    # canonicalization + hashing happen only at the g-strided grid + tail
    # positions
    with jax.named_scope("window"):
        hi, lo, valid = kmer_hi_lo(codes, lens, kg)

        def pick(a):
            t = jnp.take_along_axis(a, jstar[:, None].astype(jnp.int32), axis=1)
            return jnp.concatenate([a[:, ::g], t], axis=1)

        hi_s, lo_s, valid_c = pick(hi), pick(lo), pick(valid)
        c_hi, c_lo, fwd_cc, _palin = _canonical_keys(hi_s, lo_s, kg)
        h1_c, h2_c = bucket_hashes_jnp(c_hi, c_lo, nb)
        hi_c, lo_c = _bitcast_i32(c_hi), _bitcast_i32(c_lo)
    Q = hi_c.shape[1] - 1

    packedrow = "gband_packedrow" in tables
    S = tables["gband_bucket"].shape[1] // (4 if packedrow else 5)

    def probe_bucket(h):
        hh = h.astype(jnp.int32)
        if indirect:
            # two-level: 8-lane pointer row (32 B) -> packed bucket row
            # (NIMBLE_TPU_GBAND_INDIRECT=1; loses the dense-layout A/B
            # but uses 5x less HBM)
            pr = tables["gband_ptr8"][hh >> 3]  # (B, Q+1, 8)
            lane = (hh & 7)[..., None] == jnp.arange(8, dtype=jnp.int32)
            hh = jnp.sum(jnp.where(lane, pr, 0), axis=-1)
        row = tables["gband_bucket"][hh]  # (B, Q+1, 4S or 5S)
        match = (row[..., 0:S] == hi_c[..., None]) & (
            row[..., S : 2 * S] == lo_c[..., None]
        )
        if packedrow:
            # w0 = idx_s | vs<<18 | vd<<24, w1 = idx_d | rvs<<18 | rvd<<24
            w0 = jnp.max(
                jnp.where(match, row[..., 2 * S : 3 * S], -1), axis=-1
            )
            w1 = jnp.max(
                jnp.where(match, row[..., 3 * S : 4 * S], -1), axis=-1
            )
            i_s = jnp.where(w0 >= 0, w0 & 0x3FFFF, -1)
            i_d = jnp.where(w1 >= 0, w1 & 0x3FFFF, -1)
            mw = (
                ((w0 >> 18) & 0x3F)
                | (((w0 >> 24) & 0x3F) << 8)
                | (((w1 >> 18) & 0x3F) << 16)
                | (((w1 >> 24) & 0x3F) << 24)
            )
            mw = jnp.where(w0 >= 0, mw, 0)
            return i_s, i_d, mw
        i_s = jnp.max(jnp.where(match, row[..., 2 * S : 3 * S], -1), axis=-1)
        i_d = jnp.max(jnp.where(match, row[..., 3 * S : 4 * S], -1), axis=-1)
        mw = jnp.where(match, row[..., 4 * S : 5 * S], 0).sum(axis=2)
        return i_s, i_d, mw

    idx_s, idx_d, mword = probe_bucket(h1_c)
    if "gband_single" not in tables:
        i2s, i2d, m2 = probe_bucket(h2_c)
        idx_s = jnp.maximum(idx_s, i2s)
        idx_d = jnp.maximum(idx_d, i2d)
        mword = mword | m2  # a key matches in exactly one bucket
    n_stash = tables["gband_stash_hi"].shape[0]
    for s in range(n_stash):
        m = (tables["gband_stash_hi"][s] == hi_c) & (
            tables["gband_stash_lo"][s] == lo_c
        )
        idx_s = jnp.where(m, tables["gband_stash_idx_s"][s], idx_s)
        idx_d = jnp.where(m, tables["gband_stash_idx_d"][s], idx_d)
        mword = mword | jnp.where(m, tables["gband_stash_mask"][s], 0)
    hit = valid_c & (idx_s >= 0)
    mword = jnp.where(hit, mword, 0)

    gmask = jnp.int32((1 << g) - 1)
    mask_f = jnp.where(fwd_cc, mword, mword >> 8) & gmask
    mask_r = jnp.where(fwd_cc, mword >> 24, mword >> 16) & gmask

    score_f, score_r = coverage_score2(
        group_win_matched(mask_f, Q, g, P, jstar),
        group_win_matched(mask_r, Q, g, P, jstar),
        lens, p.k, L, 1,
    )
    if p.strand_filter == "fiveprime":
        use_fwd = jnp.ones_like(score_f, dtype=bool)
    elif p.strand_filter == "threeprime":
        use_fwd = jnp.zeros_like(score_f, dtype=bool)
    else:  # unstranded: higher-scoring orientation, ties -> forward
        use_fwd = score_f >= score_r

    # selected orientation's half row per position: s when the canonical
    # orientation agrees with the read's selected orientation, else d
    # (band_sel = use_fwd ? (fwd_c ? s : d) : (fwd_c ? d : s))
    u = use_fwd[:, None]
    idx_sel = jnp.where(fwd_cc == u, idx_s, idx_d)
    has_sel = jnp.where(u, mask_f, mask_r) != 0
    brow = tables["gband_table"][jnp.clip(idx_sel, 0, None)]
    bits = band_tree_expand(brow, has_sel, W, Pw)
    score = jnp.where(use_fwd, score_f, score_r)
    return bits, score, score_f, score_r


def group_win_matched(mask, Q: int, g: int, P: int, jstar):
    """Per-window matched bools (B, P) in window coordinates from group-probe
    masks (B, Q+1): unpack the g-bit grid masks (probe q answers windows
    g*q .. g*q+g-1), then OR in the tail probe's windows at jstar + i via
    one-hot compares."""
    B = mask.shape[0]
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    planes = [((mask[:, :Q] >> i) & 1).astype(bool) for i in range(g)]
    m = jnp.stack(planes, axis=2).reshape(B, Q * g)
    if Q * g < P:
        m = jnp.pad(m, ((0, 0), (0, P - Q * g)))
    tmask = mask[:, Q]
    for i in range(g):
        tm = ((tmask >> i) & 1).astype(bool)  # (B,)
        m = m | ((pos == (jstar + i)[:, None]) & tm[:, None])
    return m


def coverage_score(matched: jnp.ndarray, lens: jnp.ndarray, k: int, L: int, stride: int = 1):
    """Number of bases covered by >= 1 matched k-mer window ("score in bp").

    Window j starts at base j*stride. Base b is covered iff some matched j
    satisfies j*stride <= b <= j*stride + k - 1; computed with a
    trailing-window cumsum over window indices."""
    B, P = matched.shape
    mc = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=jnp.int32), jnp.cumsum(matched.astype(jnp.int32), axis=1)],
        axis=1,
    )  # (B, P+1)
    b = np.arange(L)
    j_high = b // stride
    j_low = -((-(b - k + 1)) // stride)  # ceil((b-k+1)/stride), sign-safe
    hi_idx = np.minimum(j_high + 1, P)
    lo_idx = np.clip(j_low, 0, P)
    covered = (mc[:, hi_idx] - mc[:, lo_idx]) > 0  # (B, L)
    in_read = jnp.arange(L, dtype=jnp.int32)[None, :] < lens[:, None]
    return jnp.sum(covered & in_read, axis=1).astype(jnp.int32)


def coverage_score2(matched_f, matched_r, lens, k: int, L: int, stride: int = 1):
    """Both orientations' coverage scores in ONE cumsum + window pass: the
    forward window count rides the low uint16 half and the reverse count
    the high half of a single int32 plane (counts <= P <= 16363 fit, and
    the packed cumsum stays < 2^31 for every max_len the engines accept —
    MAX_LEN_LIMIT). Bit-identical to two coverage_score calls at half the
    vector work (NIMBLE_TPU_NO_COV2=1 keeps the two-call path for A/B)."""
    if os.environ.get("NIMBLE_TPU_NO_COV2", "") == "1":
        return (
            coverage_score(matched_f, lens, k, L, stride),
            coverage_score(matched_r, lens, k, L, stride),
        )
    B, P = matched_f.shape
    packed = matched_f.astype(jnp.int32) + (matched_r.astype(jnp.int32) << 16)
    mc = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=jnp.int32), jnp.cumsum(packed, axis=1)],
        axis=1,
    )
    b = np.arange(L)
    j_high = b // stride
    j_low = -((-(b - k + 1)) // stride)
    hi_idx = np.minimum(j_high + 1, P)
    lo_idx = np.clip(j_low, 0, P)
    win = mc[:, hi_idx] - mc[:, lo_idx]  # (B, L), two uint16 fields
    in_read = jnp.arange(L, dtype=jnp.int32)[None, :] < lens[:, None]
    cov_f = ((win & 0xFFFF) > 0) & in_read
    cov_r = (jax.lax.shift_right_logical(win, 16) > 0) & in_read
    return (
        jnp.sum(cov_f, axis=1).astype(jnp.int32),
        jnp.sum(cov_r, axis=1).astype(jnp.int32),
    )


def and_reduce_bits(rows: jnp.ndarray, matched: jnp.ndarray) -> jnp.ndarray:
    """AND-reduce (B, P, W) bitset rows over matched positions -> (B, W).
    Misses contribute the identity (all ones); reads with zero matched
    positions end all-zero (unmapped). Uses a halving tree of plain
    elementwise ANDs (lax.reduce with a custom computation compiles
    pathologically in this XLA build)."""
    rows = jnp.where(matched[..., None], rows, jnp.int32(-1))
    n = rows.shape[1]
    while n > 1:
        half = n // 2
        lower = rows[:, :half] & rows[:, half : 2 * half]
        if n % 2:
            lower = lower.at[:, 0].set(lower[:, 0] & rows[:, -1])
        rows = lower
        n = half
    acc = rows[:, 0]
    any_match = jnp.any(matched, axis=1)
    return jnp.where(any_match[:, None], acc, jnp.int32(0))


def intersect_class_bits(class_ids, matched, class_bits):
    """Bitwise-AND of class bitsets over matched positions -> (B, W) uint32.
    Misses contribute the identity (all ones). Reads with zero matched
    positions end with all-zero bitsets (unmapped).

    Wide feature spaces (W > 32) use RUNS-COMPACTED gathering: consecutive
    windows almost always repeat the previous window's equivalence class
    (classes change only at SNP/feature-boundary crossings), and AND is
    idempotent, so gathering ONE class_bits row per run of equal consecutive
    ids is exact. A while_loop over RUN_BLOCK-slot blocks trips
    ceil(max_runs_in_chunk / RUN_BLOCK) times — data-adaptive, vs the old
    fori_loop's P sequential (B, W)-row gathers."""
    B, P = class_ids.shape
    W = class_bits.shape[1]
    ones = jnp.full((B, W), -1, dtype=jnp.int32)  # all-ones bit pattern

    if W <= 32:
        rows = class_bits[jnp.clip(class_ids, 0, None)]  # (B, P, W)
        return and_reduce_bits(rows, matched)

    cls = jnp.where(matched, class_ids, -1)
    prev = jnp.concatenate(
        [jnp.full((B, 1), -2, dtype=jnp.int32), cls[:, :-1]], axis=1
    )
    newrun = matched & (cls != prev)  # run starts (over-marking is harmless)
    rank = jnp.cumsum(newrun.astype(jnp.int32), axis=1) - 1
    max_runs = jnp.max(jnp.sum(newrun.astype(jnp.int32), axis=1))
    db = jnp.arange(RUN_BLOCK, dtype=jnp.int32)

    def cond(st):
        blk, _ = st
        return blk * RUN_BLOCK < max_runs

    def body(st):
        blk, acc = st
        base = blk * RUN_BLOCK
        # slot-select the next RUN_BLOCK run-start classes per read via a
        # one-hot rank compare (no scatter/sort)
        hit = newrun[:, :, None] & (
            rank[:, :, None] == (base + db)[None, None, :]
        )
        ids = jnp.max(jnp.where(hit, cls[:, :, None], -1), axis=1)  # (B, Db)
        rows = class_bits[jnp.clip(ids, 0, None)]  # (B, Db, W)
        rows = jnp.where(ids[..., None] >= 0, rows, jnp.int32(-1))
        n = RUN_BLOCK
        while n > 1:  # halving AND tree over the block axis
            half = n // 2
            lower = rows[:, :half] & rows[:, half : 2 * half]
            if n % 2:
                lower = lower.at[:, 0].set(lower[:, 0] & rows[:, -1])
            rows = lower
            n = half
        return blk + 1, acc & rows[:, 0]

    _, acc = jax.lax.while_loop(cond, body, (jnp.int32(0), ones))
    any_match = jnp.any(matched, axis=1)
    return jnp.where(any_match[:, None], acc, jnp.int32(0))


def intersect_class_bands(class_ids, matched, bandrow, W: int):
    """Runs-compacted intersection over BANDED class bitsets
    (_build_class_bands): same run structure as the wide branch of
    intersect_class_bits, but each run gathers a (1 + 2*Pw)-word band row
    instead of a W-word bitset row (10-20x less HBM traffic at W ~ 625)
    and blocks combine through the page-select tree (_band_combine)."""
    B, P = class_ids.shape
    Wb = bandrow.shape[1] - 1
    Pw = Wb // 2

    cls = jnp.where(matched, class_ids, -1)
    prev = jnp.concatenate(
        [jnp.full((B, 1), -2, dtype=jnp.int32), cls[:, :-1]], axis=1
    )
    newrun = matched & (cls != prev)
    rank = jnp.cumsum(newrun.astype(jnp.int32), axis=1) - 1
    max_runs = jnp.max(jnp.sum(newrun.astype(jnp.int32), axis=1))
    db = jnp.arange(RUN_BLOCK, dtype=jnp.int32)

    def cond(st):
        blk = st[0]
        return blk * RUN_BLOCK < max_runs

    def body(st):
        blk, apg, abd, ahas = st
        base = blk * RUN_BLOCK
        hit = newrun[:, :, None] & (
            rank[:, :, None] == (base + db)[None, None, :]
        )
        ids = jnp.max(jnp.where(hit, cls[:, :, None], -1), axis=1)  # (B, Db)
        rows = bandrow[jnp.clip(ids, 0, None)]  # (B, Db, 1+Wb)
        pg, bd, has = _band_tree(
            rows[..., 0], rows[..., 1:], ids >= 0, Pw
        )
        apg, abd, ahas = _band_combine(apg, abd, ahas, pg, bd, has, Pw)
        return blk + 1, apg, abd, ahas

    init = (
        jnp.int32(0),
        jnp.zeros((B,), dtype=jnp.int32),
        jnp.zeros((B, Wb), dtype=jnp.int32),
        jnp.zeros((B,), dtype=bool),
    )
    _, apg, abd, ahas = jax.lax.while_loop(cond, body, init)
    return _expand_band(apg, abd, ahas, W, Pw)


def revcomp_device(codes: jnp.ndarray, lens: jnp.ndarray):
    """Per-read reverse complement keeping padding at the tail."""
    B, L = codes.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = lens[:, None] - 1 - pos
    flipped = jnp.take_along_axis(codes, jnp.clip(src, 0, L - 1), axis=1)
    comp = jnp.where(flipped < 4, 3 - flipped, flipped)
    return jnp.where(src >= 0, comp, jnp.int8(N_CODE)).astype(codes.dtype)


def _select_orientation(bits_f_w, bits_r_w, matched_f, matched_r, score_f, score_r, p):
    """Strand-filter orientation selection + single AND-intersection over
    the selected orientation's bitset rows. Returns
    (bits, score, fwd_score, rev_score)."""
    if p.strand_filter == "fiveprime":
        use_fwd = jnp.ones_like(score_f, dtype=bool)
    elif p.strand_filter == "threeprime":
        use_fwd = jnp.zeros_like(score_f, dtype=bool)
    else:  # unstranded: higher-scoring orientation, ties -> forward
        use_fwd = score_f >= score_r
    sel_rows = jnp.where(use_fwd[:, None, None], bits_f_w, bits_r_w)
    matched_sel = jnp.where(use_fwd[:, None], matched_f, matched_r)
    bits = and_reduce_bits(sel_rows, matched_sel)
    score = jnp.where(use_fwd, score_f, score_r)
    return bits, score, score_f, score_r


def _score_mate(codes, lens, tables, p: AlignParams):
    """Score one mate in both orientations; returns
    (bits, score, fwd_score, rev_score) after orientation selection.

    A single canonical probe answers both orientations (cls_rev holds, at
    forward-coordinate position p, the class matched by the reverse
    complement's corresponding window; coverage and intersection are
    invariant under the coordinate reflection)."""
    if p.group_g >= 2 and "group_bucket" in tables:
        return _score_mate_group(codes, lens, tables, p)
    if p.group_g >= 2 and "gband_bucket" in tables:
        return _score_mate_groupband(codes, lens, tables, p)
    if p.group_g >= 2 and "groupcls_bucket" in tables:
        return _score_mate_groupcls(codes, lens, tables, p)

    inline = "stash_vs_bits" in tables  # static: bitsets inlined in buckets
    mono = inline and "mono_bucket" in tables

    with jax.named_scope("window"):
        hi, lo, valid = kmer_hi_lo(codes, lens, p.k)
    if p.stride > 1:
        hi = hi[:, :: p.stride]
        lo = lo[:, :: p.stride]
        valid = valid[:, :: p.stride]

    if inline:
        W = tables["class_bits"].shape[1]
        if mono:  # static: single-hash 1-row probe
            bits_f_w, bits_r_w = lookup_mono_bits(hi, lo, valid, tables, p.k, W)
        else:
            bits_f_w, bits_r_w = lookup_inline_bits(
                hi, lo, valid, tables, p.n_buckets, p.k, W
            )
        matched_f = jnp.any(bits_f_w != 0, axis=-1)
        matched_r = jnp.any(bits_r_w != 0, axis=-1)
    else:
        if "mcls_bucket" in tables:
            cls_f, cls_r = lookup_monocls(hi, lo, valid, tables, p.k)
        else:
            cls_f, cls_r = lookup_classes(
                hi, lo, valid, tables, p.n_buckets, p.k
            )
        matched_f = cls_f >= 0
        matched_r = cls_r >= 0

    score_f, score_r = coverage_score2(
        matched_f, matched_r, lens, p.k, codes.shape[1], p.stride
    )

    if p.strand_filter == "fiveprime":
        use_fwd = jnp.ones_like(score_f, dtype=bool)
    elif p.strand_filter == "threeprime":
        use_fwd = jnp.zeros_like(score_f, dtype=bool)
    else:  # unstranded: higher-scoring orientation, ties -> forward
        use_fwd = score_f >= score_r

    # intersect only the selected orientation (one bitset row per window)
    if inline:
        sel_rows = jnp.where(use_fwd[:, None, None], bits_f_w, bits_r_w)
        matched_sel = jnp.where(use_fwd[:, None], matched_f, matched_r)
        bits = and_reduce_bits(sel_rows, matched_sel)
    else:
        cls_sel = jnp.where(use_fwd[:, None], cls_f, cls_r)
        matched_sel = cls_sel >= 0
        if "class_bandrow" in tables:
            bits = intersect_class_bands(
                cls_sel, matched_sel, tables["class_bandrow"],
                tables["class_bits"].shape[1],
            )
        else:
            bits = intersect_class_bits(
                cls_sel, matched_sel, tables["class_bits"]
            )
    score = jnp.where(use_fwd, score_f, score_r)
    return bits, score, score_f, score_r


def align_step(tables, p: AlignParams, r1_codes, r1_lens, r2_codes=None, r2_lens=None):
    """One jittable alignment step over a read(-pair) batch.

    Returns dict: bits (B, W) uint32 final feature bitset, score (B,) int32
    total score, r1_fwd/r1_rev/r2_fwd/r2_rev orientation scores, r1_score/
    r2_score selected per-mate scores, pass_ (B,) bool score-filter verdict.
    """
    m1 = _score_mate(r1_codes, r1_lens, tables, p)
    m2 = _score_mate(r2_codes, r2_lens, tables, p) if r2_codes is not None else None
    return combine_mates(p, r1_lens, m1, r2_lens, m2)


def combine_mates(p: AlignParams, r1_lens, m1, r2_lens=None, m2=None):
    """Mate hit-set combination + score filters from per-mate
    (bits, score, fwd_score, rev_score) tuples. Shared by the single- and
    stacked-library align steps."""
    bits1, score1, f1, r1 = m1
    valid1 = (
        (score1 >= p.score_threshold)
        & (score1.astype(jnp.float32) >= p.score_percent * r1_lens.astype(jnp.float32))
        & jnp.any(bits1 != 0, axis=1)
    )

    if m2 is not None:
        bits2, score2, f2, r2 = m2
        valid2 = (
            (score2 >= p.score_threshold)
            & (score2.astype(jnp.float32) >= p.score_percent * r2_lens.astype(jnp.float32))
            & jnp.any(bits2 != 0, axis=1)
        )
        b1 = jnp.where(valid1[:, None], bits1, jnp.int32(0))
        b2 = jnp.where(valid2[:, None], bits2, jnp.int32(0))
        union = b1 | b2
        inter = b1 & b2
        both = valid1 & valid2
        single = jnp.where(valid1[:, None], b1, b2)
        # mate hit-set combination (kallisto-style mate intersection):
        #   0: intersect; empty intersection -> unmapped pair
        #   1: intersect with fallback to the union when empty
        #   2: force concordance: both mates must hit and intersect
        if p.intersect_level == 1:
            inter_nonempty = jnp.any(inter != 0, axis=1)
            paired = jnp.where(inter_nonempty[:, None], inter, union)
            bits = jnp.where(both[:, None], paired, single)
        elif p.intersect_level == 2:
            bits = jnp.where(both[:, None], inter, jnp.int32(0))
        else:
            bits = jnp.where(both[:, None], inter, single)
        score = jnp.where(valid1, score1, 0) + jnp.where(valid2, score2, 0)
        any_valid = valid1 | valid2
        if p.require_valid_pair:
            any_valid = both
            bits = jnp.where(both[:, None], bits, jnp.int32(0))
    else:
        bits = jnp.where(valid1[:, None], bits1, jnp.int32(0))
        score = jnp.where(valid1, score1, 0)
        any_valid = valid1
        f2 = r2 = jnp.zeros_like(score1)

    pass_ = any_valid & (score >= p.score_filter) & jnp.any(bits != 0, axis=1)
    return {
        "bits": bits,
        "score": score,
        "r1_fwd": f1,
        "r1_rev": r1,
        "r2_fwd": f2,
        "r2_rev": r2,
        "pass_": pass_,
    }


class AlignEngine:
    """Compiled single-device alignment engine over fixed-shape chunks."""

    def __init__(
        self,
        index: KmerIndex,
        config: Config,
        strand_filter: str = "unstranded",
        chunk_size: Optional[int] = 2048,
        max_len: int = 256,
        paired: bool = False,
        mesh=None,
        group_probe: Optional[bool] = None,
        chunk_cap: Optional[int] = None,
        scan_chunks: Optional[int] = None,
        compact_out: Optional[bool] = None,
        compact_slots: Optional[int] = None,
        compact_spill: Optional[int] = None,
        emit_cap: Optional[int] = None,
    ):
        self.index = index
        self.config = config
        self.params = AlignParams.from_config(config, index, strand_filter)
        self.max_len = max(max_len, index.k)
        self.paired = paired
        self.mesh = mesh

        # group-probe mode: one (k+g-1)-mer gather answers g windows —
        # available when the index carries group entries, the feature space
        # is narrow enough to inline 2g bitset planes per slot, and reads
        # are probed at stride 1 (the group grid subsumes striding)
        import os as _os

        # (wide feature spaces W > INLINE_BITS_MAX_WORDS use the class-id
        # group table, _build_groupcls_tables, so no W cap applies; widths
        # between GROUP_MAX_WORDS and the inline cap keep the mono probe)
        W = index.bitset_words
        group_ok = (
            index.has_pairs
            and (W <= GROUP_MAX_WORDS or W > INLINE_BITS_MAX_WORDS)
            and self.params.stride == 1
            and self.max_len >= index.k + index.pair_g - 1
            and _os.environ.get("NIMBLE_TPU_NO_GROUP_PROBE", "") != "1"
        )
        if group_probe is not None:
            group_ok = group_ok and group_probe

        if chunk_size is None:
            chunk_size = auto_chunk_size(index, self.max_len, paired, group_ok)
            if chunk_cap is not None and chunk_cap < chunk_size:
                # stay within the caller's batch size (a chunk larger than
                # the read batches would pad every batch)
                chunk_size = max(1 << int(np.log2(max(chunk_cap, 1))), 1)

        if mesh is not None:
            from nimble_tpu.parallel.mesh import shard_tables

            # chunk must tile the data axis; inlined bucket bitsets cannot
            # shard over the feature axis, so fall back to the separate
            # class table when that axis is split
            chunk_size = -(-chunk_size // mesh.n_data) * mesh.n_data
            self.tables = shard_tables(
                _device_tables(
                    index,
                    inline_ok=(mesh.n_feature == 1),
                    group_ok=group_ok and mesh.n_feature == 1,
                ),
                mesh,
            )
            in_shardings = [mesh.batch_sharded, mesh.data_sharded]
            if paired:
                in_shardings += [mesh.batch_sharded, mesh.data_sharded]
            jit_kwargs = dict(in_shardings=tuple([None] + in_shardings))
        else:
            self.tables = _device_tables(index, group_ok=group_ok)
            jit_kwargs = {}
        if (
            "group_bucket" in self.tables
            or "gband_bucket" in self.tables
            or "groupcls_bucket" in self.tables
        ):
            import dataclasses as _dc

            self.params = _dc.replace(self.params, group_g=index.pair_g)
        self.chunk_size = chunk_size

        p = self.params
        if paired:
            self._fn = jax.jit(
                lambda t, c1, l1, c2, l2: align_step(t, p, c1, l1, c2, l2),
                **jit_kwargs,
            )
        else:
            self._fn = jax.jit(
                lambda t, c1, l1: align_step(t, p, c1, l1), **jit_kwargs
            )
        # dispatch path: outputs packed into ONE flat int32 array, so a
        # call costs one device->host transfer instead of one per key
        self._fn_packed = jax.jit(
            lambda t, *xs: pack_outputs(align_step(t, p, *xs)), **jit_kwargs
        )

        # scanned multi-chunk dispatch: lax.scan over S stacked chunks runs
        # S chunks in ONE call while transients stay at one-chunk size; the
        # emission cap and the compact/idlist/banded wires below exist only
        # on this path. Accelerator default; the CPU keeps single chunks.
        self.scan_chunks = 1
        if scan_chunks is not None:
            self.scan_chunks = max(1, int(scan_chunks))
        elif mesh is None and accel.on_accelerator():
            self.scan_chunks = SCAN_CHUNKS_DEFAULT
        self._scan_fn = None
        if self.scan_chunks > 1:

            def scan_step(t, *stacked):
                def body(carry, xs):
                    return carry, pack_outputs(align_step(t, p, *xs))

                _, outs = jax.lax.scan(body, None, stacked)
                return outs.reshape(-1)

            self._scan_fn = jax.jit(scan_step)

        # packed-input dispatch (io/packing.py wire format): reads arrive as
        # 2-bit words + a sparse N sidecar instead of int8 codes, a quarter
        # of the host->device bytes. jit compilation is lazy, so the packed
        # variants cost nothing unless used.
        if self.max_len > MAX_LEN_LIMIT:
            raise ValueError(
                f"max_len {self.max_len} > {MAX_LEN_LIMIT} (packed uint16 scores)"
            )
        self.packed_ok = True
        self.sidecar_cap = 0
        L = self.max_len
        Lf = (L + 31) // 32
        n_mates = 2 if paired else 1

        def packed_to_codes(xs):
            # xs: per mate (words, lens, nflags_dense)
            args = []
            for m in range(n_mates):
                w, l, f = xs[3 * m : 3 * m + 3]
                args += [unpack_reads(w, L, f), l.astype(jnp.int32)]
            return args

        # mesh runs shard the packed wire over the data axis too: words
        # (B, Lw) and dense N flags (B, Lf) on the batch axis, lens on the
        # 1-D data axis. unpack_reads is pure per-row shift/mask work, so
        # the SPMD partitioner splits it with no collectives. (The sparse
        # N sidecar carries global row indices; mesh dispatch uses the
        # dense-flag single-chunk path instead — align_packed_async.)
        pk_kwargs = {}
        if mesh is not None:
            pk = [
                mesh.batch_sharded, mesh.data_sharded, mesh.batch_sharded
            ] * n_mates
            pk_kwargs = dict(in_shardings=tuple([None] + pk))
        self._fn_packed_in = jax.jit(
            lambda t, *xs: pack_outputs(align_step(t, p, *packed_to_codes(xs))),
            **pk_kwargs,
        )
        # compact wire codec (pack_outputs_compact): on by default for the
        # accelerator's scanned dispatch path, whose output was validated
        # on hardware. Off by default on the CPU: the codec returns zero rev
        # scores, and CPU differential tests compare every output key.
        if compact_out is None:
            env = os.environ.get("NIMBLE_TPU_COMPACT_OUT", "1")
            if env == "0":
                compact_out = False
            elif env == "force":
                compact_out = True
            else:
                compact_out = accel.on_accelerator()
        self.compact_out = bool(compact_out)
        self.compact_slots = int(
            compact_slots
            if compact_slots is not None
            else os.environ.get("NIMBLE_TPU_COMPACT_SLOTS", "16384")
        )
        self.compact_spill = int(
            compact_spill
            if compact_spill is not None
            else os.environ.get("NIMBLE_TPU_COMPACT_SPILL", "8192")
        )
        # slot = hash & (H-1) needs a power-of-two dictionary; the w1
        # layout holds a 14-bit slot field
        self.compact_slots = min(
            16384, max(2, 1 << (self.compact_slots - 1).bit_length())
        )

        self._scan_fn_packed = None
        self._scan_fn_packed_dense = None
        self._scan_fn_packed_full = None
        self._scan_fn_packed_dense_full = None
        self.emit_cap = 0  # set by the scanned path below when applicable
        self._idlist_wire = None
        if self.scan_chunks > 1:
            S, C = self.scan_chunks, self.chunk_size
            self.sidecar_cap = max(256, (S * C) // 16)
            cap = self.sidecar_cap
            cH, cSP = self.compact_slots, self.compact_spill
            # the packed scan path only exists mesh-less (packed_ok), so
            # the traced bits width equals index.bitset_words and whether a
            # span's payload is compact-format is STATIC. No payload-size
            # sniffing (sizes can collide between formats/widths); collect
            # trusts the dispatch-time tag and unpack gets W explicitly.
            W_idx = int(index.bitset_words)
            self._compact_W = W_idx
            use_compact = self.compact_out and 2 <= W_idx <= GROUP_MAX_WORDS
            # banded wire: wide-W gband results compress exactly to
            # [page | 2-page band] rows (compress_band_rows docstring) —
            # 1+Wb words through the dictionary codec instead of W+3 full
            # format (625+3 at 20k alleles = 2.5 KB/read, wire-dead).
            # The intersect_level=1 paired union fallback can exceed a
            # 2-page span, so that configuration keeps the full format.
            self._banded_wire = None
            if (
                self.compact_out
                and "gband_bucket" in self.tables
                and W_idx > GROUP_MAX_WORDS
                and (not paired or self.params.intersect_level != 1)
            ):
                Wb = int(self.tables["gband_table"].shape[1]) - 1
                self._banded_wire = (Wb // 2, W_idx)
                self._compact_W = 1 + Wb
                use_compact = True
            self.compact_out = use_compact

            # device-side emission cap (the wide-path wire saver): when
            # group_on is off, host emission DROPS any read whose
            # ambiguity class exceeds max_hits_to_report (or the stricter
            # discard_multi* bounds; pipeline.resolve_features_compact),
            # so shipping those rows' bitsets is pure waste — worse, at
            # wide W every backbone read's ~kilofeature class is a
            # distinct dictionary payload, overflowing the compact spill
            # and forcing 628-word full-format reruns.
            # Clearing pass_ on device for over-cap classes is
            # semantics-identical (those rows never reach the TSV) and
            # keeps the dictionary to the small classes that survive.
            # group_on collapses features->groups BEFORE the size filters,
            # so the cap only applies when group_on is empty.
            if emit_cap is None:
                emit_cap = 0
                if not str(getattr(config, "group_on", "") or ""):
                    cap = int(getattr(config, "max_hits_to_report", 0) or 0)
                    if getattr(config, "discard_multiple_matches", False):
                        cap = min(cap, 1) if cap else 1
                    dmh = int(getattr(config, "discard_multi_hits", 0) or 0)
                    if dmh > 0:
                        cap = min(cap, dmh) if cap else dmh
                    emit_cap = max(cap, 0)
            else:
                emit_cap = int(emit_cap)  # explicit override (0 disables)
            self.emit_cap = emit_cap

            def apply_emit_cap(out, counted_rows):
                if not emit_cap:
                    return out
                k = _popcount32_rows(counted_rows)
                ok = k <= emit_cap
                return {
                    **out,
                    "pass_": out["pass_"] * ok.astype(out["pass_"].dtype),
                }

            # idlist wire: with the emission cap active, every surviving
            # class has <= cap features, so per-read id lists (2+cap
            # words) beat the band+dictionary codec's fixed H*(1+2Pw)
            # words/chunk AND remove the overflow path (pack_outputs_idlist
            # docstring). Selected statically per engine.
            self._idlist_wire = None
            if self._banded_wire is not None and emit_cap > 0:
                # (cap, Pw, packed16, hdr1): int16-pair id packing needs
                # ids to fit 15 bits (0xFFFF is the absent sentinel);
                # hdr1 needs score <= 2*max_len to fit 10 bits and each
                # forward score 9 bits
                self._idlist_wire = (
                    emit_cap,
                    self._banded_wire[0],
                    index.n_features <= 32767,
                    2 * self.max_len <= 1023,
                )

            def emit(out):
                W = out["bits"].shape[1]
                if self._banded_wire is not None:
                    Pw_b, W_full = self._banded_wire
                    if W != W_full:
                        raise AssertionError(
                            f"traced bits width {W} != static {W_full}"
                        )
                    rows = compress_band_rows(out["bits"], Pw_b)
                    # band rows carry every nonzero word, so counting the
                    # (1+2Pw)-word band equals counting the W-word bitset
                    out = apply_emit_cap(out, rows[:, 1:])
                    if self._idlist_wire is not None:
                        return pack_outputs_idlist(
                            {**out, "_band": rows}, emit_cap, Pw_b,
                            packed16=self._idlist_wire[2],
                            hdr1=self._idlist_wire[3],
                        )
                    return pack_outputs_compact(
                        {**out, "bits": rows}, cH, cSP
                    )
                if use_compact:
                    if W != self._compact_W:
                        raise AssertionError(
                            f"traced bits width {W} != static {self._compact_W}"
                        )
                    out = apply_emit_cap(out, out["bits"])
                    return pack_outputs_compact(out, cH, cSP)
                return pack_outputs(out)

            def scan_packed(sparse_n, emit_fn, t, *args):
                # per mate: words (S,C,Lw), lens (S,C), then either sidecar
                # (n_idx (cap,), n_rows (cap,Lf)) or dense nflags (S,C,Lf)
                stacked = []
                for m in range(n_mates):
                    w, l, f = args[3 * m : 3 * m + 3]
                    if sparse_n:
                        f = scatter_nflags(f[0], f[1], S * C).reshape(S, C, Lf)
                    stacked += [w, l, f]

                def body(carry, xs):
                    return carry, emit_fn(align_step(t, p, *packed_to_codes(xs)))

                _, outs = jax.lax.scan(body, None, tuple(stacked))
                return outs.reshape(-1)

            self._scan_fn_packed = jax.jit(
                lambda t, *a: scan_packed(True, emit, t, *a)
            )
            self._scan_fn_packed_dense = jax.jit(
                lambda t, *a: scan_packed(False, emit, t, *a)
            )
            # full-format fallbacks for compact spill overflow (lazy jit:
            # compiled only if an overflow ever happens)
            self._scan_fn_packed_full = jax.jit(
                lambda t, *a: scan_packed(True, pack_outputs, t, *a)
            )
            self._scan_fn_packed_dense_full = jax.jit(
                lambda t, *a: scan_packed(False, pack_outputs, t, *a)
            )

    @property
    def probe_path(self) -> str:
        """Name of the probe path this engine's tables select."""
        for key, name in (
            ("group_bucket", "group"),
            ("gband_bucket", "gband"),
            ("groupcls_bucket", "groupcls"),
            ("mono_bucket", "mono"),
            ("mcls_bucket", "monocls"),
        ):
            if key in self.tables:
                return name
        return "two-choice"

    @property
    def wire(self) -> str:
        """Output wire format of the dispatch path."""
        if self.scan_chunks <= 1:
            return "full"
        if self._idlist_wire is not None:
            return "idlist"
        if self._banded_wire is not None:
            return "banded"
        return "compact" if self.compact_out else "full"

    def _pad(self, arr, n, fill):
        if arr.shape[0] == n:
            return arr
        pad_width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad_width, constant_values=fill)

    def align_batch_async(
        self,
        r1_codes: np.ndarray,
        r1_lens: np.ndarray,
        r2_codes: Optional[np.ndarray] = None,
        r2_lens: Optional[np.ndarray] = None,
    ):
        """Dispatch a host batch to the device (no wait). Returns a list of
        (packed device array, valid length) entries for collect_async.

        With scan_chunks > 1 every span of S chunks dispatches as ONE
        scanned call (the final partial span is padded up, so every call
        has one compiled shape); outputs come back as one packed flat array
        per call."""
        n = r1_codes.shape[0]
        pending = []
        S = self.scan_chunks
        if S > 1:
            span = S * self.chunk_size
            shape = (S, self.chunk_size)
            for start in range(0, n, span):
                end = min(start + span, n)
                args = [
                    self._pad(r1_codes[start:end], span, N_CODE).reshape(
                        shape + r1_codes.shape[1:]
                    ),
                    self._pad(r1_lens[start:end], span, 0).reshape(shape),
                ]
                if self.paired:
                    args += [
                        self._pad(r2_codes[start:end], span, N_CODE).reshape(
                            shape + r2_codes.shape[1:]
                        ),
                        self._pad(r2_lens[start:end], span, 0).reshape(shape),
                    ]
                pending.append((self._scan_fn(self.tables, *args), end - start))
            return pending
        for start in range(0, n, self.chunk_size):
            end = min(start + self.chunk_size, n)
            c1 = self._pad(r1_codes[start:end], self.chunk_size, N_CODE)
            l1 = self._pad(r1_lens[start:end], self.chunk_size, 0)
            if self.paired:
                c2 = self._pad(r2_codes[start:end], self.chunk_size, N_CODE)
                l2 = self._pad(r2_lens[start:end], self.chunk_size, 0)
                out = self._fn_packed(self.tables, c1, l1, c2, l2)
            else:
                out = self._fn_packed(self.tables, c1, l1)
            pending.append((out, end - start))
        return pending

    def _mate_span_args(self, words, lens, nidx, nrows, start, end, span):
        """Assemble one mate's packed args for a [start, end) span: padded
        (S, C, ...) words/lens plus either the sparse N sidecar (when the
        span's N-read count fits sidecar_cap) or a dense flag plane."""
        S, C = self.scan_chunks, self.chunk_size
        Lf = (self.max_len + 31) // 32
        shape = (S, C)
        w = self._pad(words[start:end], span, 0).reshape(shape + words.shape[1:])
        l = self._pad(lens[start:end], span, 0).reshape(shape).astype(np.int16)
        lo = int(np.searchsorted(nidx, start))
        hi = int(np.searchsorted(nidx, end))
        cnt = hi - lo
        if cnt <= self.sidecar_cap:
            idx = np.full(self.sidecar_cap, span, dtype=np.int32)  # drop pad
            rows = np.zeros((self.sidecar_cap, Lf), dtype=np.int32)
            idx[:cnt] = nidx[lo:hi] - start
            rows[:cnt] = nrows[lo:hi]
            return True, (w, l, (idx, rows))
        dense = np.zeros((span, Lf), dtype=np.int32)
        dense[nidx[lo:hi] - start] = nrows[lo:hi]
        return False, (w, l, dense.reshape(S, C, Lf))

    def align_packed_async(self, pb: dict):
        """Dispatch a packed-wire batch (io.packing.pack_batch dict) to the
        device. Same pending-list contract as align_batch_async."""
        n = pb["r1_words"].shape[0]
        pending = []
        S = self.scan_chunks
        if S > 1:
            span = S * self.chunk_size
            for start in range(0, n, span):
                end = min(start + span, n)
                sparse1, a1 = self._mate_span_args(
                    pb["r1_words"], pb["r1_lens"], pb["r1_nidx"], pb["r1_nrows"],
                    start, end, span,
                )
                args = list(a1)
                sparse_all = sparse1
                if self.paired:
                    sparse2, a2 = self._mate_span_args(
                        pb["r2_words"], pb["r2_lens"], pb["r2_nidx"],
                        pb["r2_nrows"], start, end, span,
                    )
                    sparse_all = sparse1 and sparse2
                    if sparse_all != sparse1 or sparse_all != sparse2:
                        # one jit signature per span: if either mate spills
                        # to dense, both go dense
                        _, a1 = self._densify(a1, span)
                        _, a2 = self._densify(a2, span)
                        args = list(a1) + list(a2)
                    else:
                        args += list(a2)
                # StackedEngine borrows this method and has no compact codec
                compact = getattr(self, "compact_out", False)
                if sparse_all:
                    fn = self._scan_fn_packed
                    fn_full = getattr(self, "_scan_fn_packed_full", None)
                else:
                    fn = self._scan_fn_packed_dense
                    fn_full = getattr(self, "_scan_fn_packed_dense_full", None)
                res = fn(self.tables, *args)
                if getattr(self, "_idlist_wire", None) is not None:
                    # dispatch-time format tag (never inferred from size);
                    # idlist has no overflow, so no full-format fallback
                    pending.append((res, end - start, "idlist"))
                elif compact and fn_full is not None:
                    # keep args + full-format fn for spill-overflow rerun
                    pending.append((res, end - start, fn_full, tuple(args)))
                else:
                    pending.append((res, end - start))
            return pending
        # single-chunk path (CPU tests / scan disabled): dense flags
        Lf = (self.max_len + 31) // 32
        for start in range(0, n, self.chunk_size):
            end = min(start + self.chunk_size, n)
            args = []
            for mate in ("r1", "r2") if self.paired else ("r1",):
                w = self._pad(pb[f"{mate}_words"][start:end], self.chunk_size, 0)
                l = self._pad(
                    pb[f"{mate}_lens"][start:end], self.chunk_size, 0
                ).astype(np.int16)
                nidx = pb[f"{mate}_nidx"]
                nrows = pb[f"{mate}_nrows"]
                lo = int(np.searchsorted(nidx, start))
                hi = int(np.searchsorted(nidx, end))
                dense = np.zeros((self.chunk_size, Lf), dtype=np.int32)
                dense[nidx[lo:hi] - start] = nrows[lo:hi]
                args += [w, l, dense]
            pending.append((self._fn_packed_in(self.tables, *args), end - start))
        return pending

    def warmup(self) -> int:
        """AOT-compile this engine's CLI dispatch programs on zero-filled
        spans so their executables land in the (persistent) compilation
        cache before any real read is seen. Returns the number of programs
        compiled/loaded.

        A cold `align` serializes its compiles into its first span;
        `nimble_tpu index --warm` calls this at index-build time so the
        first real run's jit calls hit the disk cache instead. Compiles
        exactly what
        align_packed_async dispatches for this engine's geometry: the
        scanned packed-wire program in both N-sidecar variants (sparse +
        dense), or the single-chunk packed program when scanning is off.
        The compact spill-overflow fallbacks stay lazy (rare by design)."""
        span = self.chunk_size * max(self.scan_chunks, 1)
        L = self.max_len
        Lw = (L + 15) // 16
        Lf = (L + 31) // 32
        mates = ("r1", "r2") if self.paired else ("r1",)

        def zero_batch(n_flagged: int) -> dict:
            pb = {}
            for mate in mates:
                pb[f"{mate}_words"] = np.zeros((span, Lw), dtype=np.int32)
                pb[f"{mate}_lens"] = np.full(span, L, dtype=np.int32)
                pb[f"{mate}_nidx"] = np.arange(n_flagged, dtype=np.int32)
                pb[f"{mate}_nrows"] = np.zeros((n_flagged, Lf), dtype=np.int32)
            return pb

        compiled = 0
        # sparse-sidecar variant (no N reads), then the dense-flag variant
        # (every read flagged overflows sidecar_cap exactly like a real
        # N-heavy span would)
        for n_flagged in (0,) if self.scan_chunks <= 1 else (0, span):
            pending = self.align_packed_async(zero_batch(n_flagged))
            self.collect_async(pending)  # blocks until compiled + executed
            compiled += 1
        return compiled

    @staticmethod
    def _densify(mate_args, span):
        """Sidecar mate args -> dense-flag mate args (span level)."""
        w, l, f = mate_args
        if not isinstance(f, tuple):
            return False, (w, l, f)
        idx, rows = f
        Lf = rows.shape[1]
        dense = np.zeros((span, Lf), dtype=np.int32)
        keep = idx < span
        dense[idx[keep]] = rows[keep]
        S = w.shape[0]
        return False, (w, l, dense.reshape(S, span // S, Lf))

    def collect_async(self, pending, expand_band: bool = True):
        """Transfer dispatched packed outputs to host numpy and unpack.

        The bits width is derived from the packed row size (a feature-split
        mesh pads the bitset width to a multiple of its feature axis, so
        index.bitset_words is a lower bound, not the runtime width).

        expand_band=False (the pipeline's emission path) keeps banded-wire
        spans in their narrow (n, 1+2*Pw) band-row form: out["bits"] is
        absent and out["band_rows"]/out["band_meta"]=(Pw, W) carry the
        class sets instead, for resolve_features_band — expanding 262k
        reads to 625 dense words per span just to re-unique them is host
        work for nothing."""
        rows = self.chunk_size * max(self.scan_chunks, 1)
        C, H, SP = self.chunk_size, self.compact_slots, self.compact_spill
        outs = []
        for entry in pending:
            flat, valid = entry[0], entry[1]
            arr = np.asarray(flat)
            if len(entry) == 3 and entry[2] == "idlist":
                outs.append(
                    unpack_outputs_idlist(
                        arr, C, self._idlist_wire[0], valid,
                        packed16=self._idlist_wire[2],
                        hdr1=self._idlist_wire[3],
                    )
                )
                continue
            # entries carry (fn_full, args) exactly when the span was
            # dispatched compact-format (align_packed_async) — the format
            # is static per engine, never inferred from payload size
            if len(entry) >= 4:
                try:
                    out = unpack_outputs_compact(
                        arr, C, H, SP, valid, W=self._compact_W
                    )
                    bw = getattr(self, "_banded_wire", None)
                    if bw is not None:
                        if expand_band:
                            out["bits"] = expand_band_rows_np(
                                out["bits"], bw[0], bw[1]
                            )
                        else:
                            out["band_rows"] = out.pop("bits")
                            out["band_meta"] = (bw[0], bw[1])
                    outs.append(out)
                    continue
                except CompactOverflow as e:
                    # pathological collision load: rerun this span in the
                    # full format (exactness over wire bytes). Loud: a
                    # full-format span is W+3 words/read on the wire
                    # (~100x the compact rate at wide W), so a run paying
                    # this repeatedly is a performance bug, not a detail.
                    self.overflow_spans = getattr(self, "overflow_spans", 0) + 1
                    import sys as _sys

                    print(
                        f"nimble_tpu: compact wire overflow #"
                        f"{self.overflow_spans} ({e}); rerunning span in "
                        "full format (slow wire)",
                        file=_sys.stderr,
                    )
                    fn_full, args = entry[2], entry[3]
                    arr = np.asarray(fn_full(self.tables, *args))
            W = arr.size // rows - PACKED_EXTRA
            out = unpack_outputs(arr, W, valid)
            bw = getattr(self, "_banded_wire", None)
            if bw is not None and not expand_band:
                # keep the rare overflow span in band-row form so the
                # merged output is format-uniform for resolve_features_band
                out["band_rows"] = compress_band_rows_np(
                    out.pop("bits"), bw[0]
                )
                out["band_meta"] = (bw[0], bw[1])
            outs.append(out)
        if not outs:
            return None
        meta = outs[0].pop("band_meta", None)
        for o in outs[1:]:
            o.pop("band_meta", None)
        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        if meta is not None:
            merged["band_meta"] = meta
        return merged

    def align_batch(
        self,
        r1_codes: np.ndarray,
        r1_lens: np.ndarray,
        r2_codes: Optional[np.ndarray] = None,
        r2_lens: Optional[np.ndarray] = None,
    ):
        """Align a host batch of arbitrary size; returns host numpy outputs."""
        return self.collect_async(
            self.align_batch_async(r1_codes, r1_lens, r2_codes, r2_lens)
        )
