"""Alignment engine tests against a brute-force Python oracle implementing
the same semantics (coverage score in bases, kallisto-style class
intersection, orientation selection, pair combination, score filters)."""
import numpy as np
import pytest

from nimble_tpu import seq as seqmod
from nimble_tpu.align.engine import AlignEngine, AlignParams, align_step, _device_tables
from nimble_tpu.align.pipeline import EmitConfig, decode_bitsets, resolve_features
from nimble_tpu.config import Config, Data
from nimble_tpu.index.builder import build_index


def make_data(seqs, names=None, extra=None):
    data = Data()
    names = names or [f"f{i}" for i in range(len(seqs))]
    for i, s in enumerate(seqs):
        data.columns[0].append("lib")
        data.columns[1].append(names[i])
        data.columns[2].append(str(len(s)))
        data.columns[3].append(s)
    if extra:
        for header, col in extra.items():
            data.headers.append(header)
            data.columns.append(col)
    return data


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def oracle_kmer_map(seqs, k):
    m = {}
    for fid, s in enumerate(seqs):
        codes = seqmod.encode(s)
        km, valid = seqmod.kmer_codes_u64(codes, k)
        for c in km[valid]:
            m.setdefault(int(c), set()).add(fid)
    return m


def oracle_mate(read, kmer_map, k, n_features):
    """Brute-force single-orientation score + feature set for one read."""
    codes = seqmod.encode(read)
    km, valid = seqmod.kmer_codes_u64(codes, k)
    matched_pos = [i for i in range(len(km)) if valid[i] and int(km[i]) in kmer_map]
    covered = set()
    for p in matched_pos:
        covered.update(range(p, p + k))
    feats = None
    for p in matched_pos:
        s = kmer_map[int(km[p])]
        feats = set(s) if feats is None else feats & s
    return len(covered), (feats or set())


def oracle_best(read, kmer_map, k, n_features):
    """Orientation-selected (unstranded, ties -> forward) mate result."""
    sf, ff = oracle_mate(read, kmer_map, k, n_features)
    sr, fr = oracle_mate(seqmod.revcomp(read), kmer_map, k, n_features)
    if sf >= sr:
        return sf, ff, sf, sr
    return sr, fr, sf, sr


@pytest.fixture(scope="module")
def hla_like():
    rng = np.random.default_rng(7)
    backbone = rand_seq(rng, 1000)
    seqs = []
    for _ in range(12):
        s = list(backbone)
        for pos in rng.integers(0, 1000, size=25):
            s[pos] = "ACGT"[rng.integers(0, 4)]
        seqs.append("".join(s))
    seqs.append(rand_seq(rng, 800))  # one unrelated feature
    return seqs


def sample_reads(rng, seqs, n, read_len, error_rate=0.0, revcomp_frac=0.5):
    reads = []
    for _ in range(n):
        src = seqs[rng.integers(0, len(seqs))]
        start = rng.integers(0, len(src) - read_len + 1)
        r = list(src[start : start + read_len])
        for i in range(read_len):
            if rng.random() < error_rate:
                r[i] = "ACGT"[rng.integers(0, 4)]
        r = "".join(r)
        if rng.random() < revcomp_frac:
            r = seqmod.revcomp(r)
        reads.append(r)
    return reads


def engine_results(seqs, reads, config=None, k=21, group_probe=False, **kw):
    # group_probe defaults OFF here: these oracles pin the per-window (mono)
    # contract; the group path has its own oracle in TestGroupProbe
    config = config or Config()
    data = make_data(seqs)
    index = build_index(data, config, k=k)
    engine = AlignEngine(
        index, config, max_len=max(len(r) for r in reads),
        group_probe=group_probe, **kw,
    )
    codes, lens = seqmod.encode_batch(reads, engine.max_len)
    out = engine.align_batch(codes, lens)
    return index, out


class TestSingleEnd:
    def test_perfect_reads_match_oracle(self, hla_like):
        rng = np.random.default_rng(11)
        reads = sample_reads(rng, hla_like, 64, read_len=100)
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        index, out = engine_results(hla_like, reads, cfg)
        kmap = oracle_kmer_map(hla_like, 21)
        member = decode_bitsets(out["bits"], index.n_features)
        for i, read in enumerate(reads):
            score, feats, sf, sr = oracle_best(read, kmap, 21, index.n_features)
            assert out["score"][i] == score, read
            assert out["r1_fwd"][i] == sf
            assert out["r1_rev"][i] == sr
            got = set(np.nonzero(member[i])[0])
            assert got == feats, (i, got, feats)

    def test_noisy_reads_match_oracle(self, hla_like):
        rng = np.random.default_rng(13)
        reads = sample_reads(rng, hla_like, 64, read_len=120, error_rate=0.02)
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        index, out = engine_results(hla_like, reads, cfg)
        kmap = oracle_kmer_map(hla_like, 21)
        member = decode_bitsets(out["bits"], index.n_features)
        for i, read in enumerate(reads):
            score, feats, _, _ = oracle_best(read, kmap, 21, index.n_features)
            if not feats:
                # empty class intersection => unmapped: engine zeroes the read
                assert out["score"][i] == 0
                assert not member[i].any()
            else:
                assert out["score"][i] == score
                assert set(np.nonzero(member[i])[0]) == feats

    def test_unrelated_reads_miss(self, hla_like):
        rng = np.random.default_rng(17)
        reads = [rand_seq(rng, 100) for _ in range(16)]
        index, out = engine_results(hla_like, reads, Config())
        assert not out["pass_"].any()
        assert (out["bits"] == 0).all()

    def test_reads_with_n_bases(self, hla_like):
        rng = np.random.default_rng(19)
        reads = sample_reads(rng, hla_like, 8, read_len=100, revcomp_frac=0)
        reads = [r[:50] + "N" + r[51:] for r in reads]
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        index, out = engine_results(hla_like, reads, cfg)
        kmap = oracle_kmer_map(hla_like, 21)
        for i, read in enumerate(reads):
            score, _, _, _ = oracle_best(read, kmap, 21, index.n_features)
            assert out["score"][i] == score

    def test_score_filters(self, hla_like):
        rng = np.random.default_rng(23)
        reads = sample_reads(rng, hla_like, 32, read_len=100)
        # absurd filter: nothing passes
        _, out = engine_results(hla_like, reads, Config(score_filter=1000))
        assert not out["pass_"].any()
        # score_percent = 1.0 requires full-length coverage
        cfg = Config(score_threshold=0, score_filter=0, score_percent=1.0)
        _, out = engine_results(hla_like, reads, cfg)
        assert (out["score"][out["pass_"]] == 100).all()

    def test_short_and_varied_lengths(self, hla_like):
        rng = np.random.default_rng(29)
        r100 = sample_reads(rng, hla_like, 4, read_len=100, revcomp_frac=0)
        r30 = sample_reads(rng, hla_like, 4, read_len=30, revcomp_frac=0)
        reads = r100 + r30
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        index, out = engine_results(hla_like, reads, cfg)
        kmap = oracle_kmer_map(hla_like, 21)
        for i, read in enumerate(reads):
            score, _, _, _ = oracle_best(read, kmap, 21, index.n_features)
            assert out["score"][i] == score


class TestPaired:
    def run_paired(self, seqs, pairs, config, k=21):
        data = make_data(seqs)
        index = build_index(data, config, k=k)
        max_len = max(max(len(a), len(b)) for a, b in pairs)
        engine = AlignEngine(index, config, max_len=max_len, paired=True)
        c1, l1 = seqmod.encode_batch([p[0] for p in pairs], max_len)
        c2, l2 = seqmod.encode_batch([p[1] for p in pairs], max_len)
        return index, engine.align_batch(c1, l1, c2, l2)

    def test_pair_intersection_level0(self, hla_like):
        # default: kallisto-style mate intersection
        src = hla_like[0]
        pairs = [(src[0:100], seqmod.revcomp(src[150:250])) for _ in range(4)]
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0, intersect_level=0)
        index, out = self.run_paired(hla_like, pairs, cfg)
        assert out["pass_"].all()
        kmap = oracle_kmer_map(hla_like, 21)
        member = decode_bitsets(out["bits"], index.n_features)
        _, f1, _, _ = oracle_best(pairs[0][0], kmap, 21, index.n_features)
        _, f2, _, _ = oracle_best(pairs[0][1], kmap, 21, index.n_features)
        assert set(np.nonzero(member[0])[0]) == (f1 & f2)
        assert out["score"][0] == 200

    def test_pair_union_fallback_level1(self, hla_like):
        src = hla_like[0]
        pairs = [(src[0:100], seqmod.revcomp(src[150:250]))]
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0, intersect_level=1)
        index, out = self.run_paired(hla_like, pairs, cfg)
        kmap = oracle_kmer_map(hla_like, 21)
        member = decode_bitsets(out["bits"], index.n_features)
        _, f1, _, _ = oracle_best(pairs[0][0], kmap, 21, index.n_features)
        _, f2, _, _ = oracle_best(pairs[0][1], kmap, 21, index.n_features)
        expected = (f1 & f2) if (f1 & f2) else (f1 | f2)
        assert set(np.nonzero(member[0])[0]) == expected

    def test_pair_force_level2_drops_single_mate(self, hla_like):
        rng = np.random.default_rng(53)
        src = hla_like[0]
        junk = rand_seq(rng, 100)
        pairs = [(src[0:100], junk)]
        cfg = Config(score_threshold=20, score_filter=0, score_percent=0.0, intersect_level=2)
        _, out = self.run_paired(hla_like, pairs, cfg)
        assert not out["pass_"].any()

    def test_require_valid_pair(self, hla_like):
        rng = np.random.default_rng(37)
        src = hla_like[0]
        junk = rand_seq(rng, 100)
        pairs = [(src[0:100], junk)]
        cfg = Config(
            score_threshold=20, score_filter=0, score_percent=0.0, require_valid_pair=True
        )
        _, out = self.run_paired(hla_like, pairs, cfg)
        assert not out["pass_"].any()
        cfg2 = Config(score_threshold=20, score_filter=0, score_percent=0.0)
        _, out2 = self.run_paired(hla_like, pairs, cfg2)
        assert out2["pass_"].all()  # r1 alone carries the pair


class TestEmission:
    def test_resolve_features_group_on(self):
        rng = np.random.default_rng(41)
        seqs = [rand_seq(rng, 200) for _ in range(4)]
        data = make_data(
            seqs, names=["a1", "a2", "b1", "b2"],
            extra={"lineage": ["L1", "L1", "L2", "L2"]},
        )
        cfg = Config(group_on="lineage")
        index = build_index(data, cfg, k=15)
        # bitset with features {a1, a2} -> group L1 only
        bits = np.zeros((2, index.bitset_words), dtype=np.uint32)
        bits[0, 0] = 0b0011  # a1, a2
        bits[1, 0] = 0b0110  # a2, b1
        emit = EmitConfig(True, False, 0, 10)
        feats, keep = resolve_features(index, bits, emit)
        assert feats[0] == "L1"
        assert feats[1] == "L1,L2"
        assert keep.all()

    def test_resolve_features_filters(self):
        rng = np.random.default_rng(43)
        seqs = [rand_seq(rng, 200) for _ in range(3)]
        index = build_index(make_data(seqs), Config(), k=15)
        bits = np.zeros((3, index.bitset_words), dtype=np.uint32)
        bits[0, 0] = 0b001
        bits[1, 0] = 0b011
        bits[2, 0] = 0b111
        feats, keep = resolve_features(index, bits, EmitConfig(False, True, 0, 10))
        assert keep.tolist() == [True, False, False]  # discard_multiple_matches
        feats, keep = resolve_features(index, bits, EmitConfig(False, False, 2, 10))
        assert keep.tolist() == [True, True, False]  # discard_multi_hits=2
        feats, keep = resolve_features(index, bits, EmitConfig(False, False, 0, 2))
        assert keep.tolist() == [True, True, False]  # max_hits_to_report=2
        assert feats[1] == "f0,f1"


def test_revcomp_hi_lo_matches_host():
    import jax.numpy as jnp
    from nimble_tpu.align.engine import revcomp_hi_lo

    rng = np.random.default_rng(99)
    for k in (5, 15, 16, 21, 31):
        codes = rng.integers(0, 1 << min(2 * k, 63), size=256, dtype=np.uint64)
        codes &= (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
        expected = seqmod.revcomp_kmer_u64(codes, k)
        hi = (codes >> np.uint64(32)).astype(np.uint32)
        lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        oh, ol = revcomp_hi_lo(jnp.asarray(hi), jnp.asarray(lo), k)
        got = (np.asarray(oh).astype(np.uint64) << np.uint64(32)) | np.asarray(ol).astype(np.uint64)
        assert np.array_equal(got, expected), k


def oracle_strided(read, kmer_map, k, stride):
    """Strided oracle in forward coordinates: at each sampled forward window
    position, the forward k-mer and its reverse complement probe the map
    (matching the engine's canonical-probe sampling)."""
    codes = seqmod.encode(read)
    km, valid = seqmod.kmer_codes_u64(codes, k)
    rc = seqmod.revcomp_kmer_u64(km, k) if len(km) else km

    def orient(keys):
        matched = [p for p in range(0, len(km), stride) if valid[p] and int(keys[p]) in kmer_map]
        covered = set()
        feats = None
        for p in matched:
            covered.update(range(p, p + k))
            s = kmer_map[int(keys[p])]
            feats = set(s) if feats is None else feats & s
        return len(covered), (feats or set())

    sf, ff = orient(km)
    sr, fr = orient(rc)
    return (sf, ff) if sf >= sr else (sr, fr)


def test_stride_matches_strided_oracle(hla_like):
    rng = np.random.default_rng(71)
    reads = sample_reads(rng, hla_like, 48, read_len=100, error_rate=0.01)
    cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0, kmer_stride=3)
    index, out = engine_results(hla_like, reads, cfg)
    kmap = oracle_kmer_map(hla_like, 21)
    member = decode_bitsets(out["bits"], index.n_features)
    for i, read in enumerate(reads):
        score, feats = oracle_strided(read, kmap, 21, 3)
        if not feats:
            assert out["score"][i] == 0
        else:
            assert out["score"][i] == score
            assert set(np.nonzero(member[i])[0]) == feats


def test_large_feature_space_paths(hla_like):
    """>512 features disables bitset inlining and exercises the separate
    class-table path with W > 32 words (fori-loop intersection)."""
    rng = np.random.default_rng(83)
    backbone = rand_seq(rng, 260)
    seqs = []
    for i in range(1100):
        s = list(backbone)
        for pos in rng.integers(0, 260, size=6):
            s[pos] = "ACGT"[rng.integers(0, 4)]
        seqs.append("".join(s))
    cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
    data = make_data(seqs)
    index = build_index(data, cfg, k=21)
    assert index.bitset_words > 32
    engine = AlignEngine(index, cfg, max_len=80, chunk_size=32)
    assert "stash_vs_bits" not in engine.tables  # inline disabled

    reads = sample_reads(rng, seqs, 24, read_len=80)
    codes, lens = seqmod.encode_batch(reads, 80)
    out = engine.align_batch(codes, lens)
    kmap = oracle_kmer_map(seqs, 21)
    member = decode_bitsets(out["bits"], index.n_features)
    for i, read in enumerate(reads):
        score, feats, _, _ = oracle_best(read, kmap, 21, index.n_features)
        if feats:
            assert out["score"][i] == score
            assert set(np.nonzero(member[i])[0]) == feats
        else:
            assert out["score"][i] == 0


def test_revcomp_device_matches_host():
    import jax.numpy as jnp
    from nimble_tpu.align.engine import revcomp_device

    rng = np.random.default_rng(101)
    reads = [rand_seq(rng, int(rng.integers(20, 60))) for _ in range(8)]
    codes, lens = seqmod.encode_batch(reads, 60)
    out = np.asarray(revcomp_device(jnp.asarray(codes), jnp.asarray(lens)))
    for i, read in enumerate(reads):
        got = seqmod.decode(out[i][: lens[i]])
        assert got == seqmod.revcomp(read)
        assert (out[i][lens[i]:] == seqmod.N_CODE).all()


class TestGroupProbe:
    """The group-probe path: one canonical (k+g-1)-mer gather answers g
    windows (engine._score_mate_group). Contract: bit-identical to the mono
    path on reads whose probed groups are library-resident (all clean
    reads); conservative (windows adjacent to an error/N may be lost) on
    noisy reads — pinned exactly by oracle_group below."""

    def _run(self, seqs, reads, cfg, group, k=21, max_len=None):
        data = make_data(seqs)
        index = build_index(data, cfg, k=k)
        engine = AlignEngine(
            index, cfg, max_len=max_len or max(len(r) for r in reads),
            group_probe=group,
        )
        if group:
            assert "group_bucket" in engine.tables, "group path not active"
            assert engine.params.group_g >= 2
            assert "mono_bucket" not in engine.tables
        codes, lens = seqmod.encode_batch(reads, engine.max_len)
        return index, engine.align_batch(codes, lens)

    def test_clean_reads_bit_identical_to_mono(self, hla_like):
        # every read-length parity (the tail probe's coverage of the final
        # window depends on len-k parity), reads at sequence starts/ends,
        # and reverse-complemented reads. Reads must be >= k+g-1 bases for
        # the parity contract — shorter reads are unmapped on the group path
        # (documented conservative divergence; see the short-read test).
        from nimble_tpu.index.builder import _group_g

        kg = 21 + _group_g() - 1
        rng = np.random.default_rng(31)
        reads = []
        for rl in (100, 101, 99, kg, kg + 1, kg + 2):
            reads += sample_reads(rng, hla_like, 8, read_len=rl)
        reads += [s[: 100] for s in hla_like]          # sequence starts
        reads += [s[-100:] for s in hla_like]          # sequence ends
        reads += [seqmod.revcomp(s[-64:]) for s in hla_like]
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        _, mono = self._run(hla_like, reads, cfg, group=False, max_len=101)
        _, grp = self._run(hla_like, reads, cfg, group=True, max_len=101)
        for key in ("bits", "score", "r1_fwd", "r1_rev", "pass_"):
            np.testing.assert_array_equal(grp[key], mono[key], err_msg=key)

    def test_short_reads_unmapped_on_group_path(self, hla_like):
        """Reads shorter than k+g-1 bases carry no complete group key and
        are unmapped on the group path (conservative; the mono path maps
        them). The reference's default score_filter=25 hides all but the
        len in [k, k+g-1) corner."""
        from nimble_tpu.index.builder import _group_g

        kg = 21 + _group_g() - 1
        rng = np.random.default_rng(41)
        reads = sample_reads(rng, hla_like, 8, read_len=kg - 1)
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        _, mono = self._run(hla_like, reads, cfg, group=False, max_len=101)
        _, grp = self._run(hla_like, reads, cfg, group=True, max_len=101)
        assert (mono["score"] > 0).all()  # mono maps them
        assert (grp["score"] == 0).all()
        assert not grp["pass_"].any()
        assert (grp["bits"] == 0).all()

    def test_noisy_and_n_reads_match_group_oracle(self, hla_like):
        rng = np.random.default_rng(37)
        reads = sample_reads(rng, hla_like, 48, read_len=100, error_rate=0.03)
        reads += [r[:40] + "N" + r[41:] for r in
                  sample_reads(rng, hla_like, 8, read_len=100)]
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        index, out = self._run(hla_like, reads, cfg, group=True)
        kmap = oracle_kmer_map(hla_like, 21)
        pairset = oracle_pair_set(hla_like, 21, index.pair_g)
        member = decode_bitsets(out["bits"], index.n_features)
        for i, read in enumerate(reads):
            sf, ff = oracle_group_mate(read, kmap, pairset, 21, index.pair_g, "fwd")
            sr, fr = oracle_group_mate(read, kmap, pairset, 21, index.pair_g, "rev")
            score, feats = (sf, ff) if sf >= sr else (sr, fr)
            assert out["r1_fwd"][i] == sf, (i, read)
            assert out["r1_rev"][i] == sr, (i, read)
            if not feats:
                assert out["score"][i] == 0
                assert not member[i].any()
            else:
                assert out["score"][i] == score
                assert set(np.nonzero(member[i])[0]) == feats

    def test_noisy_reads_conservative_vs_mono(self, hla_like):
        rng = np.random.default_rng(41)
        reads = sample_reads(rng, hla_like, 64, read_len=100, error_rate=0.02)
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        _, mono = self._run(hla_like, reads, cfg, group=False)
        _, grp = self._run(hla_like, reads, cfg, group=True)
        # coverage can only drop; most reads are unaffected
        assert (grp["r1_fwd"] <= mono["r1_fwd"]).all()
        assert (grp["r1_rev"] <= mono["r1_rev"]).all()
        same = (grp["score"] == mono["score"]).mean()
        assert same >= 0.4, same

    def test_reads_shorter_than_group_are_unmapped(self, hla_like):
        # length-k reads have windows but no (k+g-1)-mer: documented
        # divergence — the group path cannot map them
        reads = [s[10 : 10 + 21] for s in hla_like[:4]]
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        _, grp = self._run(hla_like, reads, cfg, group=True, max_len=100)
        assert (grp["score"] == 0).all()


def oracle_pair_set(seqs, k, g):
    kg = k + g - 1
    out = set()
    for s in seqs:
        codes = seqmod.encode(s)
        gm, valid = seqmod.kmer_codes_u64(codes, kg)
        rc = seqmod.revcomp_kmer_u64(gm, kg)
        for c in np.minimum(gm, rc)[valid]:
            out.add(int(c))
    return out


def oracle_group_mate(read, kmap, pairset, k, g, orient):
    """Brute-force group-probe semantics for one orientation, mirroring the
    engine's probe grid: grid positions 0, g, 2g, ... plus the per-read tail
    probe at len-(k+g-1). A window is matched iff its probed group's
    canonical code is a library group AND the window's k-mer (forward for
    orient='fwd', its reverse complement for 'rev') is in the k-mer index."""
    kg = k + g - 1
    codes = seqmod.encode(read)
    km, kvalid = seqmod.kmer_codes_u64(codes, k)
    gm, gvalid = seqmod.kmer_codes_u64(codes, kg)
    l = len(read)
    PP = l - kg + 1
    probes = list(range(0, max(PP, 0), g))
    if l >= kg:
        probes.append(l - kg)
    matched = {}
    for j in probes:
        if j >= len(gm) or not gvalid[j]:
            continue
        c = int(gm[j])
        rc = int(seqmod.revcomp_kmer_u64(np.array([c], dtype=np.uint64), kg)[0])
        if min(c, rc) not in pairset:
            continue
        for i in range(g):
            w = j + i
            wc = int(km[w])
            if orient == "rev":
                wc = int(seqmod.revcomp_kmer_u64(np.array([wc], dtype=np.uint64), k)[0])
            if wc in kmap:
                matched[w] = kmap[wc]
    covered = set()
    for w in matched:
        covered.update(range(w, w + k))
    feats = None
    for w in matched:
        feats = set(matched[w]) if feats is None else feats & matched[w]
    return len(covered), (feats or set())


class TestScannedDispatch:
    """Scanned multi-chunk dispatch (lax.scan over stacked chunks, the
    accelerator's dispatch path) must be output-
    identical to chunk-by-chunk dispatch, including the non-multiple tail
    that falls back to single-chunk calls."""

    def test_scan_matches_single_chunk(self, hla_like):
        seqs = hla_like
        rng = np.random.default_rng(17)
        reads = sample_reads(rng, seqs, 300, 70, error_rate=0.01)
        config = Config()
        data = make_data(seqs)
        index = build_index(data, config, k=21)
        codes, lens = seqmod.encode_batch(reads, 70)

        plain = AlignEngine(index, config, chunk_size=64, max_len=70,
                            scan_chunks=1)
        scanned = AlignEngine(index, config, chunk_size=64, max_len=70,
                              scan_chunks=4)
        assert scanned.scan_chunks == 4 and scanned._scan_fn is not None
        a = plain.align_batch(codes, lens)
        b = scanned.align_batch(codes, lens)
        # 300 reads = 4 full chunks scanned + 44-read padded tail chunk
        for key in a:
            assert np.array_equal(a[key], b[key]), key

    def test_scan_paired(self, hla_like):
        seqs = hla_like
        rng = np.random.default_rng(18)
        r1 = sample_reads(rng, seqs, 200, 60)
        r2 = sample_reads(rng, seqs, 200, 60)
        config = Config()
        index = build_index(make_data(seqs), config, k=21)
        c1, l1 = seqmod.encode_batch(r1, 60)
        c2, l2 = seqmod.encode_batch(r2, 60)
        plain = AlignEngine(index, config, chunk_size=32, max_len=60,
                            paired=True, scan_chunks=1)
        scanned = AlignEngine(index, config, chunk_size=32, max_len=60,
                              paired=True, scan_chunks=3)
        a = plain.align_batch(c1, l1, c2, l2)
        b = scanned.align_batch(c1, l1, c2, l2)
        for key in a:
            assert np.array_equal(a[key], b[key]), key
