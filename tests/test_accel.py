"""The CPU-vs-accelerator decision and the device plumbing around it
(nimble_tpu.accel), plus the plain window and band-tree stages against
numpy oracles."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from nimble_tpu import accel
from nimble_tpu import seq as seqmod
from nimble_tpu.align import engine as E
from nimble_tpu.align.stacked import StackedEngine
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import build_index
from nimble_tpu.index.hashing import bucket_hashes_np
from nimble_tpu.io.packing import pack_batch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _lib(seed, n=12, length=300):
    rng = np.random.default_rng(seed)
    data = Data()
    seqs = []
    for i in range(n):
        s = rng.integers(0, 4, size=length).astype(np.int8)
        seqs.append(s)
        data.columns[0].append("lib")
        data.columns[1].append(f"f{i}")
        data.columns[2].append(str(length))
        data.columns[3].append(seqmod.decode(s))
    return build_index(data, Config(), k=21), seqs


def _reads(seqs, n=96, L=80, seed=1):
    rng = np.random.default_rng(seed)
    codes = np.empty((n, L), dtype=np.int8)
    for i in range(n):
        src = seqs[i % len(seqs)]
        st = int(rng.integers(0, len(src) - L))
        codes[i] = src[st : st + L]
    codes[rng.random(codes.shape) < 0.01] = 4
    return codes, np.full(n, L, dtype=np.int32)


@pytest.fixture
def as_gpu(monkeypatch):
    monkeypatch.setattr(accel, "backend", lambda: "gpu")


def test_align_engine_accelerator_config(as_gpu):
    """On an accelerator the engine takes the scanned dispatch with the
    compact wire, and its emitted output equals the CPU configuration's."""
    index, seqs = _lib(0, n=40)  # W = 2 words: the compact codec applies
    codes, lens = _reads(seqs)
    eng = E.AlignEngine(index, Config(), chunk_size=32, max_len=80)
    assert eng.scan_chunks == E.SCAN_CHUNKS_DEFAULT
    assert eng.compact_out
    cpu = E.AlignEngine(index, Config(), chunk_size=32, max_len=80,
                        scan_chunks=1, compact_out=False)
    pb = pack_batch({"r1_codes": codes, "r1_lens": lens}, 80)
    got = eng.collect_async(eng.align_packed_async(pb))
    want = cpu.collect_async(cpu.align_packed_async(pb))
    for k in ("bits", "score", "r1_fwd", "pass_"):
        assert np.array_equal(got[k], want[k]), k


def test_align_engine_cpu_config():
    index, _ = _lib(0)
    eng = E.AlignEngine(index, Config(), chunk_size=None, max_len=80)
    assert not accel.on_accelerator()
    assert eng.scan_chunks == 1 and not eng.compact_out
    assert eng.chunk_size <= E.CPU_CHUNK_MAX


def test_stacked_engine_accelerator_config(as_gpu):
    (a, _), (b, _) = _lib(0), _lib(5)
    eng = StackedEngine([a, b], [Config(), Config()], chunk_size=32, max_len=80)
    assert eng.scan_chunks == E.SCAN_CHUNKS_DEFAULT


def test_stacked_engine_cpu_config():
    (a, _), (b, _) = _lib(0), _lib(5)
    eng = StackedEngine([a, b], [Config(), Config()], chunk_size=32, max_len=80)
    assert eng.scan_chunks == 1


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is JAX's own setting: the program sets no
    other directory."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(accel.jax.config, "update", lambda *a: calls.append(a))
    assert accel.compile_cache_dir() is None
    assert calls == []


def test_compile_cache_env_unset(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(accel.jax.config, "update", lambda *a: calls.append(a))
    path = accel.compile_cache_dir()
    assert path == os.path.join(str(REPO), ".jax_cache")
    assert os.path.isdir(path)
    assert calls == [("jax_compilation_cache_dir", path)]


class _Dev:
    platform = "gpu"
    device_kind = "test card"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_memory_caps_from_bytes_limit():
    limit = 64 << 30
    assert accel.device_bytes_limit(_Dev({"bytes_limit": limit})) == limit
    assert accel.table_bytes_cap(limit) == int(limit * accel.TABLE_SHARE)


def test_memory_limit_missing_is_error():
    with pytest.raises(RuntimeError, match="bytes_limit"):
        accel.device_bytes_limit(_Dev(None))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        accel.device_bytes_limit(_Dev({"bytes_in_use": 0}))


def test_card_per_process():
    assert [accel.card_for_process(p, 4, 4) for p in range(4)] == ["0", "1", "2", "3"]
    assert accel.card_for_process(1, 2, 4) == "1"
    assert accel.card_for_process(0, 2, 0) is None  # no cards: CPU host


def test_more_processes_than_cards():
    with pytest.raises(ValueError, match="one process per card"):
        accel.card_for_process(0, 5, 4)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


@pytest.mark.parametrize("k", [15, 21, 31])
def test_window_keys_match_numpy(k):
    rng = np.random.default_rng(k)
    B, L = 24, 90
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.03] = 4  # Ns
    lens = rng.integers(k, L + 1, size=B).astype(np.int32)
    n_buckets = 1 << 12
    got = [np.asarray(a) for a in E.window_keys(
        jnp.asarray(codes), jnp.asarray(lens), k, n_buckets)]
    c_hi, c_lo, h1, h2, fwd, pal, valid = got

    P = L - k + 1
    for b in range(B):
        fw, ok = seqmod.kmer_codes_u64(codes[b], k)
        rc = seqmod.revcomp_kmer_u64(fw, k)
        canon = np.minimum(fw, rc)
        hi = (canon >> np.uint64(32)).astype(np.uint32)
        lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        r1, r2 = bucket_hashes_np(hi, lo, n_buckets)
        inside = np.arange(P) + k <= lens[b]
        assert np.array_equal(valid[b], ok & inside)
        assert np.array_equal(fwd[b], fw <= rc)
        assert np.array_equal(pal[b], fw == rc)
        assert np.array_equal(c_hi[b].view(np.uint32), hi)
        assert np.array_equal(c_lo[b].view(np.uint32), lo)
        assert np.array_equal(h1[b], r1.astype(np.int32))
        assert np.array_equal(h2[b], r2.astype(np.int32))


@pytest.mark.parametrize("W,Pw,Q1", [(625, 32, 14), (100, 16, 7), (70, 8, 5)])
def test_band_tree_expand_matches_pairwise_and(W, Pw, Q1):
    """The banded intersection + expand equals the AND of every present
    position's band placed at its page, cut to W words."""
    rng = np.random.default_rng(3)
    B, Wb = 24, 2 * Pw
    n_pages = -(-W // Pw)
    page = rng.integers(0, n_pages, size=(B, Q1)).astype(np.int32)
    band = rng.integers(0, 1 << 31, size=(B, Q1, Wb), dtype=np.int64).astype(np.int32)
    # family runs: many positions repeat the previous position's band
    for j in range(1, Q1):
        same = rng.random(B) < 0.6
        page[same, j] = page[same, j - 1]
        band[same, j] = band[same, j - 1]
    has = rng.random((B, Q1)) < 0.8
    has[:3] = False  # reads with no contribution expand to zero

    wide = (n_pages + 1) * Pw
    want = np.full((B, wide), -1, dtype=np.int32)
    for j in range(Q1):
        placed = np.zeros((B, wide), dtype=np.int32)
        cols = page[:, j, None] * Pw + np.arange(Wb)[None, :]
        np.put_along_axis(placed, cols, band[:, j], axis=1)
        want[has[:, j]] &= placed[has[:, j]]
    want = np.where(has.any(axis=1)[:, None], want[:, :W], 0)

    brow = np.concatenate([page[..., None], band], axis=-1)
    got = np.asarray(E.band_tree_expand(jnp.asarray(brow), jnp.asarray(has), W, Pw))
    assert np.array_equal(got, want)
