"""Stacked multi-library alignment: ONE probe per window for ALL libraries.

The reference aligns multiple libraries in a single pass over the reads but
runs each library's index separately per read (reference: -r/-o pairs,
nimble/__main__.py:182-189). A probe costs about one gathered row per
window, so L separate library probes cost L rows/window. This module merges the libraries' canonical k-mer entries into
one mono hash table whose per-slot payload is the CONCATENATION of each
library's (vs_bits, vd_bits) segments: one row gather answers every library
at once, and the per-library tails (coverage, orientation, mate combine,
score filters) are cheap vector ops on word-range slices.

Per-library semantics are preserved exactly: a window that matches library
A but not B carries all-zero bits in B's segment, and B's matched mask
(any(seg != 0)) routes it to the AND-identity — the same miss handling as
B's standalone engine.

Stacking requirements (validated by StackedEngine.compatible): equal k,
equal kmer_stride, and combined bitset width within the mono row budget.

When every library also carries group entries with the same g (the default
index build), the stack uses the GROUP probe instead: one (k+g-1)-mer row
gather answers g windows for all libraries at once
(build_stacked_group_tables / stacked_align_step_group) — the multi-library
analog of the engine's single-library group path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from nimble_tpu import accel
from nimble_tpu.align import engine as E
from nimble_tpu.config import Config
from nimble_tpu.index.builder import KmerIndex

# combined-width budget: mono rows stay narrow; beyond it stacking still
# wins on row count but the table memory grows linearly
STACK_MAX_WORDS = 64  # up to 2048 combined (padded) feature bits
# slots per stacked bucket: narrower rows than the single-library mono
# table because the per-slot payload is L libraries wide
STACK_SLOTS = 2


def _bits_of_fn(index: KmerIndex):
    """Class-id columns -> (n, W_l) int32 bitset rows for one library
    (zero = absent orientation)."""
    W = index.bitset_words
    cb = index.class_bits.view(np.int32)

    def bits_of(vals):
        out = np.zeros((vals.shape[0], W), dtype=np.int32)
        occ = vals >= 0
        out[occ] = cb[vals[occ]]
        return out

    return bits_of


def _lib_entries(index: KmerIndex) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One library's occupied canonical entries as (key u64, vs_bits, vd_bits)
    with bits decoded from its class table ((n, W_l) int32; zero = absent
    orientation)."""
    bits_of = _bits_of_fn(index)

    occ = (index.table_vsame >= 0) | (index.table_vdiff >= 0)
    socc = (index.stash_vsame >= 0) | (index.stash_vdiff >= 0)
    hi = np.concatenate([index.table_hi[occ], index.stash_hi[socc]])
    lo = np.concatenate([index.table_lo[occ], index.stash_lo[socc]])
    vs = np.concatenate([index.table_vsame[occ], index.stash_vsame[socc]])
    vd = np.concatenate([index.table_vdiff[occ], index.stash_vdiff[socc]])
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return keys, bits_of(vs), bits_of(vd)


def build_stacked_tables(
    indexes: Sequence[KmerIndex], slots: Optional[int] = None
) -> Optional[dict]:
    """Merge libraries' entries by canonical key into one mono table whose
    slot payload is [vs_all | vd_all] with vs_all = lib0 vs | lib1 vs | ...
    Layout matches engine._build_mono_tables (planar, slot-minor), so
    engine.mono_probe consumes it unchanged with W = sum of W_l.

    Returns the device table dict + ('seg_words', offsets) metadata, or
    None when the stack exceeds the memory/width budget."""
    widths = [ix.bitset_words for ix in indexes]
    W_cat = int(np.sum(widths))
    if W_cat > STACK_MAX_WORDS:
        return None
    offs = np.zeros(len(indexes) + 1, dtype=np.int64)
    np.cumsum(widths, out=offs[1:])

    per_lib = [_lib_entries(ix) for ix in indexes]
    all_keys = np.unique(np.concatenate([k for k, _, _ in per_lib]))
    n = all_keys.shape[0]
    if n == 0:
        return None
    vs_cat = np.zeros((n, W_cat), dtype=np.int32)
    vd_cat = np.zeros((n, W_cat), dtype=np.int32)
    for li, (keys, vsb, vdb) in enumerate(per_lib):
        pos = np.searchsorted(all_keys, keys)
        vs_cat[pos, offs[li] : offs[li + 1]] = vsb
        vd_cat[pos, offs[li] : offs[li + 1]] = vdb

    S = slots or STACK_SLOTS
    entry = 2 + 2 * W_cat
    hi = (all_keys >> np.uint64(32)).astype(np.uint32)
    lo = (all_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    # grow-until-tight single-hash placement shared with the mono and group
    # layouts (engine._single_hash_placement; see MONO_TIGHT_STASH note)
    placement = E._single_hash_placement(hi, lo, entry, S)
    if placement is None:
        return None
    nb2, b, s, keys_idx, skeys = placement

    # empty slots carry the impossible key hi = -1 (canonical hi < 2^30)
    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1
    table[b, s] = hi[keys_idx].view(np.int32)
    table[b, S + s] = lo[keys_idx].view(np.int32)
    for w in range(W_cat):
        table[b, 2 * S + w * S + s] = vs_cat[keys_idx, w]
        table[b, 2 * S + W_cat * S + w * S + s] = vd_cat[keys_idx, w]

    n_stash = int(skeys.shape[0])
    pad = max(1, n_stash)
    ms_hi = np.zeros(pad, dtype=np.int32)
    ms_lo = np.zeros(pad, dtype=np.int32)
    ms_vsb = np.zeros((pad, W_cat), dtype=np.int32)
    ms_vdb = np.zeros((pad, W_cat), dtype=np.int32)
    ms_hi[:] = -1  # padding rows can never match
    if n_stash:
        ms_hi[:n_stash] = hi[skeys].view(np.int32)
        ms_lo[:n_stash] = lo[skeys].view(np.int32)
        ms_vsb[:n_stash] = vs_cat[skeys]
        ms_vdb[:n_stash] = vd_cat[skeys]
    return {
        "mono_bucket": jnp.asarray(table),
        "mono_stash_hi": jnp.asarray(ms_hi),
        "mono_stash_lo": jnp.asarray(ms_lo),
        "mono_stash_vs_bits": jnp.asarray(ms_vsb),
        "mono_stash_vd_bits": jnp.asarray(ms_vdb),
        "seg_words": tuple(int(v) for v in offs),
    }


def build_stacked_group_tables(indexes: Sequence[KmerIndex]) -> Optional[dict]:
    """Merged GROUP-probe table across libraries: one row gather per
    (k+g-1)-mer probe answers g windows for EVERY library. Like the mono
    stack, entries are merged by canonical key and the per-slot AND-planes
    are the concatenation of each library's segment; unlike it, window
    presence is per-library, so each slot carries L packed mask words
    (engine._build_group_tables layout) instead of one:

      [hi x S | lo x S | vs_and (W_cat,S) | vd_and (W_cat,S) |
       mask_lib0 x S | ... | mask_lib{L-1} x S]

    A key absent from library li carries mask 0 and AND-identity bits in
    li's segment — its windows are simply unmatched for li, exactly as in
    li's standalone group engine. Returns None when the libraries cannot
    stack on the group path (no/unequal pair entries, width or placement
    budget); the caller falls back to the mono stack."""
    if not all(ix.has_pairs for ix in indexes):
        return None
    gs = {ix.pair_g for ix in indexes}
    if len(gs) != 1:
        return None
    g = gs.pop()
    widths = [ix.bitset_words for ix in indexes]
    W_cat = int(np.sum(widths))
    L_libs = len(indexes)
    if W_cat > STACK_MAX_WORDS:
        return None
    offs = np.zeros(L_libs + 1, dtype=np.int64)
    np.cumsum(widths, out=offs[1:])

    per_lib = []
    for ix in indexes:
        vs_and, vd_and, mask_word = E._group_entry_payload(ix, _bits_of_fn(ix))
        keys = (ix.pair_hi.astype(np.uint64) << np.uint64(32)) | ix.pair_lo.astype(
            np.uint64
        )
        per_lib.append((keys, vs_and, vd_and, mask_word))
    all_keys = np.unique(np.concatenate([k for k, _, _, _ in per_lib]))
    n = all_keys.shape[0]
    if n == 0:
        return None
    # AND-identity in absent libraries' segments (only ever consumed gated
    # on that library's mask word, which stays 0 there)
    vs_cat = np.full((n, W_cat), -1, dtype=np.int32)
    vd_cat = np.full((n, W_cat), -1, dtype=np.int32)
    masks = np.zeros((n, L_libs), dtype=np.int32)
    for li, (keys, vsb, vdb, mw) in enumerate(per_lib):
        pos = np.searchsorted(all_keys, keys)
        vs_cat[pos, offs[li] : offs[li + 1]] = vsb
        vd_cat[pos, offs[li] : offs[li + 1]] = vdb
        masks[pos, li] = mw

    S = STACK_SLOTS
    entry = 2 + 2 * W_cat + L_libs
    hi = (all_keys >> np.uint64(32)).astype(np.uint32)
    lo = (all_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    placement = E._single_hash_placement(hi, lo, entry, S)
    if placement is None:
        return None
    nb2, b, s, keys_idx, skeys = placement

    table = np.zeros((nb2, S * entry), dtype=np.int32)
    table[:, 0:S] = -1  # EMPTY key sentinel in the hi plane
    table[b, s] = hi[keys_idx].view(np.int32)
    table[b, S + s] = lo[keys_idx].view(np.int32)
    for w in range(W_cat):
        table[b, 2 * S + w * S + s] = vs_cat[keys_idx, w]
        table[b, 2 * S + W_cat * S + w * S + s] = vd_cat[keys_idx, w]
    for li in range(L_libs):
        table[b, 2 * S + 2 * W_cat * S + li * S + s] = masks[keys_idx, li]

    n_stash = int(skeys.shape[0])
    pad = max(1, n_stash)
    st_hi = np.full(pad, -1, dtype=np.int32)  # padding rows can never match
    st_lo = np.zeros(pad, dtype=np.int32)
    st_vs = np.zeros((pad, W_cat), dtype=np.int32)
    st_vd = np.zeros((pad, W_cat), dtype=np.int32)
    st_mask = np.zeros((pad, L_libs), dtype=np.int32)
    if n_stash:
        st_hi[:n_stash] = hi[skeys].view(np.int32)
        st_lo[:n_stash] = lo[skeys].view(np.int32)
        st_vs[:n_stash] = vs_cat[skeys]
        st_vd[:n_stash] = vd_cat[skeys]
        st_mask[:n_stash] = masks[skeys]
    return {
        "sg_bucket": jnp.asarray(table),
        "sg_stash_hi": jnp.asarray(st_hi),
        "sg_stash_lo": jnp.asarray(st_lo),
        "sg_stash_vs_and": jnp.asarray(st_vs),
        "sg_stash_vd_and": jnp.asarray(st_vd),
        "sg_stash_mask": jnp.asarray(st_mask),
        "seg_words": tuple(int(v) for v in offs),
        "pair_g": g,
    }


def stacked_group_probe(hi_i, lo_i, h1, fwd_c, valid, tables, W_cat: int, g: int):
    """Group probe over the merged table (engine.group_probe with L mask
    words per slot). Returns (and_f (B,Q,W_cat), mask_f (B,Q,L),
    and_r, mask_r); masks are per-library g-bit window-presence fields in
    forward coordinates."""
    B, Q = hi_i.shape
    S = STACK_SLOTS
    L_libs = tables["sg_stash_mask"].shape[1]
    row = tables["sg_bucket"][h1.astype(jnp.int32)]  # (B, Q, S*entry)
    bk_hi = row[..., 0:S]
    bk_lo = row[..., S : 2 * S]
    match = (bk_hi == hi_i[..., None]) & (bk_lo == lo_i[..., None])
    sel = match[:, :, None, :]  # (B, Q, 1, S)
    vs_and = row[..., 2 * S : 2 * S + W_cat * S].reshape(B, Q, W_cat, S)
    vd_and = row[..., 2 * S + W_cat * S : 2 * S + 2 * W_cat * S].reshape(
        B, Q, W_cat, S
    )
    vs_and = jnp.where(sel, vs_and, 0).sum(axis=3)  # (B, Q, W_cat)
    vd_and = jnp.where(sel, vd_and, 0).sum(axis=3)
    mrows = row[..., 2 * S + 2 * W_cat * S :].reshape(B, Q, L_libs, S)
    mword = jnp.where(sel, mrows, 0).sum(axis=3)  # (B, Q, L)
    n_stash = tables["sg_stash_hi"].shape[0]
    for s in range(n_stash):
        m = (tables["sg_stash_hi"][s] == hi_i) & (tables["sg_stash_lo"][s] == lo_i)
        vs_and = vs_and | jnp.where(m[..., None], tables["sg_stash_vs_and"][s], 0)
        vd_and = vd_and | jnp.where(m[..., None], tables["sg_stash_vd_and"][s], 0)
        mword = mword | jnp.where(m[..., None], tables["sg_stash_mask"][s], 0)

    gmask = jnp.int32((1 << g) - 1)
    fc = fwd_c[..., None]
    and_f = jnp.where(fc, vs_and, vd_and)
    and_r = jnp.where(fc, vd_and, vs_and)
    mask_f = jnp.where(fc, mword, mword >> 8) & gmask
    mask_r = jnp.where(fc, mword >> 24, mword >> 16) & gmask
    mask_f = jnp.where(valid[..., None], mask_f, 0)
    mask_r = jnp.where(valid[..., None], mask_r, 0)
    return and_f, mask_f, and_r, mask_r


def _group_rows(codes, lens, tables, p0: E.AlignParams, W_cat: int, g: int):
    """Window stage with (k+g-1)-mers + ONE merged-table probe per grid/tail
    position (engine._score_mate_group's probe half, shared across
    libraries). Returns (and_f, mask_f, and_r, mask_r, Q, jstar)."""
    kg = p0.k + g - 1
    B, L = codes.shape
    PP = L - kg + 1
    nb = tables["sg_bucket"].shape[0]
    hi_i, lo_i, h1, _h2, fwd_c, _palin, valid = E.window_keys(codes, lens, kg, nb)

    jstar = jnp.clip(lens - kg, 0, PP - 1)
    onehot = jnp.arange(PP, dtype=jnp.int32)[None, :] == jstar[:, None]
    cat = []
    for a in (hi_i, lo_i, h1, fwd_c, valid):
        t = jnp.where(onehot, a.astype(jnp.int32), 0).sum(axis=1, keepdims=True)
        cat.append(jnp.concatenate([a[:, ::g], t.astype(a.dtype)], axis=1))
    and_f, mask_f, and_r, mask_r = stacked_group_probe(*cat, tables, W_cat, g)
    Q = cat[0].shape[1] - 1
    return and_f, mask_f, and_r, mask_r, Q, jstar


def stacked_align_step_group(
    tables,
    params: Sequence[E.AlignParams],
    seg_words: Sequence[int],
    g: int,
    r1_codes,
    r1_lens,
    r2_codes=None,
    r2_lens=None,
) -> List[dict]:
    """Group-probe variant of stacked_align_step: one merged probe stream,
    per-library window masks / coverage / orientation / mate combine."""
    W_cat = int(seg_words[-1])
    p0 = params[0]
    rows1 = _group_rows(r1_codes, r1_lens, tables, p0, W_cat, g)
    rows2 = (
        _group_rows(r2_codes, r2_lens, tables, p0, W_cat, g)
        if r2_codes is not None
        else None
    )
    L1 = r1_codes.shape[1]

    outs = []
    for li, p in enumerate(params):
        w0, w1 = int(seg_words[li]), int(seg_words[li + 1])

        def mate(rows, lens, L):
            and_f, mask_f, and_r, mask_r, Q, jstar = rows
            mf = mask_f[..., li]
            mr = mask_r[..., li]
            P = L - p.k + 1
            sf = E.coverage_score(
                E.group_win_matched(mf, Q, g, P, jstar), lens, p.k, L, 1
            )
            sr = E.coverage_score(
                E.group_win_matched(mr, Q, g, P, jstar), lens, p.k, L, 1
            )
            return E._select_orientation(
                and_f[..., w0:w1], and_r[..., w0:w1], mf != 0, mr != 0, sf, sr, p
            )

        m1 = mate(rows1, r1_lens, L1)
        m2 = mate(rows2, r2_lens, r2_codes.shape[1]) if rows2 is not None else None
        outs.append(E.combine_mates(p, r1_lens, m1, r2_lens, m2))
    return outs


def _probe_rows(codes, lens, tables, p: E.AlignParams, W_cat: int):
    """Window stage + ONE mono probe -> ((bits_f, bits_r) rows of
    (B, P, W_cat), plus per-window validity already folded in)."""
    nb2 = tables["mono_bucket"].shape[0]
    hi_i, lo_i, h1, _h2, fc, pal, valid = E.window_keys(codes, lens, p.k, nb2)
    if p.stride > 1:
        hi_i, lo_i, h1, fc, pal, valid = (
            a[:, :: p.stride] for a in (hi_i, lo_i, h1, fc, pal, valid)
        )
    return E.mono_probe(hi_i, lo_i, h1, fc, pal, valid, tables, W_cat)


def stacked_align_step(
    tables,
    params: Sequence[E.AlignParams],
    seg_words: Sequence[int],
    r1_codes,
    r1_lens,
    r2_codes=None,
    r2_lens=None,
) -> List[dict]:
    """One jittable step: one probe per mate, L per-library tails. Returns
    one align_step-style output dict per library."""
    W_cat = int(seg_words[-1])
    p0 = params[0]  # window params (k/stride equal across libs)
    rows1 = _probe_rows(r1_codes, r1_lens, tables, p0, W_cat)
    rows2 = (
        _probe_rows(r2_codes, r2_lens, tables, p0, W_cat)
        if r2_codes is not None
        else None
    )
    L1 = r1_codes.shape[1]

    outs = []
    for li, p in enumerate(params):
        w0, w1 = int(seg_words[li]), int(seg_words[li + 1])

        def mate(rows, lens, L):
            bf = rows[0][..., w0:w1]
            br = rows[1][..., w0:w1]
            mf = jnp.any(bf != 0, axis=-1)
            mr = jnp.any(br != 0, axis=-1)
            sf = E.coverage_score(mf, lens, p.k, L, p.stride)
            sr = E.coverage_score(mr, lens, p.k, L, p.stride)
            return E._select_orientation(bf, br, mf, mr, sf, sr, p)

        m1 = mate(rows1, r1_lens, L1)
        m2 = mate(rows2, r2_lens, r2_codes.shape[1]) if rows2 is not None else None
        outs.append(E.combine_mates(p, r1_lens, m1, r2_lens, m2))
    return outs


class StackedEngine:
    """Compiled multi-library engine: AlignEngine's batch interface, but one
    device step returns per-library outputs from a single probe stream."""

    @staticmethod
    def compatible(indexes: Sequence[KmerIndex], configs: Sequence[Config]) -> bool:
        ks = {ix.k for ix in indexes}
        strides = {int(getattr(c, "kmer_stride", 1)) for c in configs}
        if len(ks) != 1 or len(strides) != 1:
            return False
        return sum(ix.bitset_words for ix in indexes) <= STACK_MAX_WORDS

    def __init__(
        self,
        indexes: Sequence[KmerIndex],
        configs: Sequence[Config],
        strand_filter: str = "unstranded",
        chunk_size: Optional[int] = 2048,
        max_len: int = 256,
        paired: bool = False,
        mesh=None,
        chunk_cap: Optional[int] = None,
        scan_chunks: Optional[int] = None,
    ):
        import os as _os

        self.indexes = list(indexes)
        self.max_len = max(max_len, indexes[0].k)
        self.paired = paired
        self.mesh = mesh

        # group-probe stack first (one (k+g-1)-mer gather answers g windows
        # for all libraries); same gates as AlignEngine's group mode
        self.group_g = 0
        tables = None
        if (
            all(ix.has_pairs for ix in indexes)
            and len({ix.pair_g for ix in indexes}) == 1
            # strict per-library equivalence: every library must be one its
            # standalone AlignEngine would also run in group mode (same
            # width gate, engine.py AlignEngine.__init__), so stacked and
            # per-library outputs stay byte-identical for any mix of widths
            and all(ix.bitset_words <= E.GROUP_MAX_WORDS for ix in indexes)
            and all(int(getattr(c, "kmer_stride", 1)) == 1 for c in configs)
            and self.max_len >= indexes[0].k + indexes[0].pair_g - 1
            and _os.environ.get("NIMBLE_TPU_NO_GROUP_PROBE", "") != "1"
        ):
            tables = build_stacked_group_tables(indexes)
        if tables is not None:
            self.group_g = tables.pop("pair_g")
        else:
            tables = build_stacked_tables(indexes)
        if tables is None:
            raise ValueError("libraries not stackable (width/memory budget)")
        self.seg_words = tables.pop("seg_words")
        if chunk_size is None:
            W_cat = int(self.seg_words[-1])
            k = indexes[0].k
            P = self.max_len - k + 1
            if self.group_g:
                g = self.group_g
                PP = max(self.max_len - (k + g - 1) + 1, 1)
                Q = (PP + g - 1) // g + 1
                per_read = (
                    Q * STACK_SLOTS * (2 + 2 * W_cat + len(indexes))
                    + 4 * Q * W_cat
                    + (10 * PP + 6 * P) * len(indexes)
                )
            else:
                per_read = (
                    P * STACK_SLOTS * (2 + 2 * W_cat) + 2 * P * W_cat + 10 * P
                )
            chunk_size = E._chunk_from_per_read(per_read, paired)
            if chunk_cap is not None and chunk_cap < chunk_size:
                chunk_size = max(1 << int(np.log2(max(chunk_cap, 1))), 1)
        self.params = [
            E.AlignParams.from_config(c, ix, strand_filter)
            for c, ix in zip(configs, indexes)
        ]
        jit_kwargs = {}
        if mesh is not None:
            # stacked tables inline every library's bitsets in the bucket
            # rows, so only read-batch (data-axis) sharding applies; a
            # feature-split mesh falls back to per-library engines upstream
            if mesh.n_feature != 1:
                raise ValueError("stacked engine shards the data axis only")
            chunk_size = -(-chunk_size // mesh.n_data) * mesh.n_data
            tables = {
                k: jax.device_put(v, mesh.replicated) for k, v in tables.items()
            }
            in_shardings = [mesh.batch_sharded, mesh.data_sharded]
            if paired:
                in_shardings += [mesh.batch_sharded, mesh.data_sharded]
            jit_kwargs = dict(in_shardings=tuple([None] + in_shardings))
        self.tables = tables
        self.chunk_size = chunk_size
        params = self.params
        seg = self.seg_words
        if self.group_g:
            g = self.group_g
            raw = lambda t, *xs: stacked_align_step_group(t, params, seg, g, *xs)  # noqa: E731
        else:
            raw = lambda t, *xs: stacked_align_step(t, params, seg, *xs)  # noqa: E731
        self._fn = jax.jit(raw, **jit_kwargs)
        # per-library bits widths for pack/unpack (engine.pack_outputs
        # rationale: ONE flat transfer per device call)
        self._lib_widths = [
            int(seg[i + 1] - seg[i]) for i in range(len(indexes))
        ]

        def packed(t, *xs):
            return jnp.concatenate(
                [E.pack_outputs(o).reshape(xs[0].shape[0], -1) for o in raw(t, *xs)],
                axis=1,
            ).reshape(-1)

        self._fn_packed = jax.jit(packed, **jit_kwargs)

        # scanned multi-chunk dispatch, chosen as for AlignEngine
        self.scan_chunks = 1
        if scan_chunks is not None:
            self.scan_chunks = max(1, int(scan_chunks))
        elif mesh is None and accel.on_accelerator():
            self.scan_chunks = E.SCAN_CHUNKS_DEFAULT
        self._scan_fn = None
        if self.scan_chunks > 1:

            def scan_step(t, *stacked):
                def body(carry, xs):
                    return carry, packed(t, *xs)

                _, outs = jax.lax.scan(body, None, stacked)
                return outs.reshape(-1)

            self._scan_fn = jax.jit(scan_step)

        # packed-input dispatch (2-bit words + sparse N sidecar), identical
        # wire format and span assembly to AlignEngine's (engine.py): the
        # stacked step only differs in what runs on the unpacked codes
        if self.max_len > E.MAX_LEN_LIMIT:
            raise ValueError(
                f"max_len {self.max_len} > {E.MAX_LEN_LIMIT} (packed uint16 scores)"
            )
        self.packed_ok = True
        self.sidecar_cap = 0
        L = self.max_len
        Lf = (L + 31) // 32
        n_mates = 2 if paired else 1

        def packed_to_codes(xs):
            args = []
            for m in range(n_mates):
                w, l, f = xs[3 * m : 3 * m + 3]
                args += [E.unpack_reads(w, L, f), l.astype(jnp.int32)]
            return args

        # mesh: shard the packed wire over the data axis (engine.py
        # rationale — words/flags batch-sharded, lens data-sharded)
        pk_kwargs = {}
        if mesh is not None:
            pk = [
                mesh.batch_sharded, mesh.data_sharded, mesh.batch_sharded
            ] * n_mates
            pk_kwargs = dict(in_shardings=tuple([None] + pk))
        self._fn_packed_in = jax.jit(
            lambda t, *xs: packed(t, *packed_to_codes(xs)), **pk_kwargs
        )
        self._scan_fn_packed = None
        self._scan_fn_packed_dense = None
        if self.scan_chunks > 1:
            S, C = self.scan_chunks, self.chunk_size
            self.sidecar_cap = max(256, (S * C) // 16)

            def scan_packed(sparse_n, t, *args):
                stacked_args = []
                for m in range(n_mates):
                    w, l, f = args[3 * m : 3 * m + 3]
                    if sparse_n:
                        f = E.scatter_nflags(f[0], f[1], S * C).reshape(S, C, Lf)
                    stacked_args += [w, l, f]

                def body(carry, xs):
                    return carry, packed(t, *packed_to_codes(xs))

                _, outs = jax.lax.scan(body, None, tuple(stacked_args))
                return outs.reshape(-1)

            self._scan_fn_packed = jax.jit(lambda t, *a: scan_packed(True, t, *a))
            self._scan_fn_packed_dense = jax.jit(
                lambda t, *a: scan_packed(False, t, *a)
            )

    _pad = E.AlignEngine._pad
    _mate_span_args = E.AlignEngine._mate_span_args
    _densify = staticmethod(E.AlignEngine._densify)
    align_packed_async = E.AlignEngine.align_packed_async

    def align_batch_async(self, r1_codes, r1_lens, r2_codes=None, r2_lens=None):
        n = r1_codes.shape[0]
        pending = []
        S = self.scan_chunks
        if S > 1:
            span = S * self.chunk_size
            shape = (S, self.chunk_size)
            for start in range(0, n, span):
                end = min(start + span, n)
                args = [
                    self._pad(r1_codes[start:end], span, E.N_CODE).reshape(
                        shape + r1_codes.shape[1:]
                    ),
                    self._pad(r1_lens[start:end], span, 0).reshape(shape),
                ]
                if self.paired:
                    args += [
                        self._pad(r2_codes[start:end], span, E.N_CODE).reshape(
                            shape + r2_codes.shape[1:]
                        ),
                        self._pad(r2_lens[start:end], span, 0).reshape(shape),
                    ]
                pending.append((self._scan_fn(self.tables, *args), end - start))
            return pending
        for start in range(0, n, self.chunk_size):
            end = min(start + self.chunk_size, n)
            c1 = self._pad(r1_codes[start:end], self.chunk_size, E.N_CODE)
            l1 = self._pad(r1_lens[start:end], self.chunk_size, 0)
            if self.paired:
                c2 = self._pad(r2_codes[start:end], self.chunk_size, E.N_CODE)
                l2 = self._pad(r2_lens[start:end], self.chunk_size, 0)
                outs = self._fn_packed(self.tables, c1, l1, c2, l2)
            else:
                outs = self._fn_packed(self.tables, c1, l1)
            pending.append((outs, end - start))
        return pending

    def collect_async(self, pending) -> Optional[List[Dict[str, np.ndarray]]]:
        """-> one host-numpy output dict per library."""
        if not pending:
            return None
        n_scalar = E.PACKED_EXTRA
        widths = [w + n_scalar for w in self._lib_widths]
        row_w = sum(widths)
        result: List[Dict[str, np.ndarray]] = []
        per_call = []
        for flat, valid in pending:
            arr = np.asarray(flat).reshape(-1, row_w)[:valid]
            per_call.append(arr)
        off = 0
        for li, w in enumerate(self._lib_widths):
            chunks = [
                E.unpack_outputs(
                    np.ascontiguousarray(a[:, off : off + w + n_scalar]).reshape(-1),
                    w,
                    a.shape[0],
                )
                for a in per_call
            ]
            result.append(
                {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
            )
            off += w + n_scalar
        return result
