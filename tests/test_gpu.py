"""Tests that need the card (marker `gpu`; the `gpu_device` fixture skips
them elsewhere). Run on the GPU with: python -m pytest -m gpu tests/ -q"""
import numpy as np
import pytest

import jax

from nimble_tpu import accel
from nimble_tpu import seq as seqmod
from nimble_tpu.align import engine as E
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import build_index
from nimble_tpu.io.packing import pack_batch

pytestmark = pytest.mark.gpu


def test_card_takes_accelerator_config(gpu_device):
    assert accel.on_accelerator()
    limit = accel.device_bytes_limit(gpu_device)
    assert limit > 1 << 30
    assert accel.memory_bytes() == limit


def test_window_keys_on_card_match_cpu(gpu_device):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, size=(4096, 100)).astype(np.int8)
    lens = rng.integers(21, 101, size=4096).astype(np.int32)
    cpu = jax.devices("cpu")[0]
    outs = []
    for dev in (gpu_device, cpu):
        c, l = jax.device_put(codes, dev), jax.device_put(lens, dev)
        outs.append([np.asarray(a) for a in jax.jit(
            lambda c, l: E.window_keys(c, l, 21, 1 << 20))(c, l)])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_engine_on_card_matches_cpu_engine(gpu_device):
    """The accelerator configuration (scanned dispatch, compact wire) on
    the card emits what the CPU configuration emits on the CPU."""
    rng = np.random.default_rng(1)
    data = Data()
    seqs = []
    for i in range(40):
        s = rng.integers(0, 4, size=300).astype(np.int8)
        seqs.append(s)
        data.columns[0].append("lib")
        data.columns[1].append(f"f{i}")
        data.columns[2].append("300")
        data.columns[3].append(seqmod.decode(s))
    index = build_index(data, Config(), k=21)
    codes = np.stack([seqs[i % 40][i % 200 : i % 200 + 80] for i in range(2048)])
    lens = np.full(2048, 80, np.int32)
    pb = pack_batch({"r1_codes": codes, "r1_lens": lens}, 80)
    eng = E.AlignEngine(index, Config(), chunk_size=256, max_len=80)
    assert eng.scan_chunks == E.SCAN_CHUNKS_DEFAULT
    got = eng.collect_async(eng.align_packed_async(pb))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = E.AlignEngine(index, Config(), chunk_size=256, max_len=80,
                            scan_chunks=1, compact_out=False)
        want = cpu.collect_async(cpu.align_packed_async(pb))
    for k in ("bits", "score", "r1_fwd", "pass_"):
        assert np.array_equal(got[k], want[k]), k
