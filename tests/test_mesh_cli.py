"""CLI-reachable multi-chip execution on the virtual 8-device CPU mesh:
`align --mesh` and `report --device/--distributed` must produce byte-equal
outputs to the single-device/host paths (the device scale-out layer the
reference lacks; reference parallelism is `-c` threads only,
nimble/__main__.py:180)."""
import os

import numpy as np
import pytest

from nimble_tpu.__main__ import main as cli
from nimble_tpu.io.fasta import write_fasta
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu.parallel.mesh import parse_mesh_spec


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    rng = np.random.default_rng(17)

    backbone = rand_seq(rng, 600)
    alleles = {}
    for i in range(6):
        s = list(backbone)
        s[80 + i * 80 : 80 + i * 80 + 40] = list(rand_seq(rng, 40))
        alleles[f"allele{i}"] = "".join(s)
    fasta = str(root / "lib.fasta")
    write_fasta(fasta, list(alleles.items()))
    library = str(root / "library.json")
    assert cli(["generate", "--file", fasta, "--output_path", library]) == 0

    other = str(root / "other.fasta")
    write_fasta(other, [("other0", rand_seq(rng, 500)), ("other1", rand_seq(rng, 500))])
    other_lib = str(root / "other.json")
    assert cli(["generate", "--file", other, "--output_path", other_lib]) == 0

    # bulk single-end reads, some reverse-complemented
    from nimble_tpu import seq as seqmod

    reads = []
    names = list(alleles)
    for i in range(60):
        allele = names[i % len(names)]
        start = 30 + (i % 12) * 40
        r = alleles[allele][start : start + 90]
        if i % 3 == 0:
            r = seqmod.revcomp(r)
        reads.append((f"read{i}", r, "I" * 90))
    fastq = str(root / "reads.fastq")
    write_fastq(fastq, reads)
    return {
        "root": str(root),
        "library": library,
        "other_lib": other_lib,
        "fastq": fastq,
    }


def read_lines(path):
    with open(path) as f:
        return f.read()


def test_parse_mesh_spec():
    plan = parse_mesh_spec("data=4,feature=2")
    assert plan.n_data == 4 and plan.n_feature == 2
    plan = parse_mesh_spec("data=8")
    assert plan.n_data == 8 and plan.n_feature == 1
    plan = parse_mesh_spec("feature=2")
    assert plan.n_data == 4 and plan.n_feature == 2  # data fills the rest
    plan = parse_mesh_spec("8")
    assert plan.n_data == 8
    plan = parse_mesh_spec("auto")
    assert plan.n_data == 8
    assert parse_mesh_spec("") is None
    with pytest.raises(ValueError):
        parse_mesh_spec("rows=2")


@pytest.mark.parametrize("mesh", ["data=8", "data=4,feature=2"])
def test_align_mesh_matches_single_device(workspace, mesh):
    root = workspace["root"]
    base = os.path.join(root, "base.tsv")
    assert cli([
        "align", "--reference", workspace["library"], "--output", base,
        "--input", workspace["fastq"], "--chunk-size", "32",
    ]) == 0
    meshed = os.path.join(root, f"mesh_{mesh.replace('=', '').replace(',', '_')}.tsv")
    assert cli([
        "align", "--reference", workspace["library"], "--output", meshed,
        "--input", workspace["fastq"], "--chunk-size", "32", "--mesh", mesh,
    ]) == 0
    assert read_lines(meshed) == read_lines(base)
    n_rows = len(read_lines(base).strip().split("\n")) - 1
    assert n_rows == 60  # every read aligns


def test_align_mesh_multi_library_stacked(workspace):
    """Stacked multi-library engine under a data-axis mesh: outputs equal
    the unmeshed run for every library."""
    root = workspace["root"]
    ref = f"{workspace['library']},{workspace['other_lib']}"
    base = os.path.join(root, "mbase.tsv")
    meshed = os.path.join(root, "mmesh.tsv")
    assert cli([
        "align", "--reference", ref, "--output", base,
        "--input", workspace["fastq"], "--chunk-size", "32",
    ]) == 0
    assert cli([
        "align", "--reference", ref, "--output", meshed,
        "--input", workspace["fastq"], "--chunk-size", "32", "--mesh", "data=8",
    ]) == 0
    for suffix in ("library", "other"):
        b = os.path.join(root, f"mbase.{suffix}.tsv")
        m = os.path.join(root, f"mmesh.{suffix}.tsv")
        assert read_lines(m) == read_lines(b)


def test_stacked_engine_mesh_parity():
    """StackedEngine(mesh=...) step outputs match the unmeshed stacked
    engine exactly."""
    from nimble_tpu import seq as seqmod
    from nimble_tpu.align.stacked import StackedEngine
    from nimble_tpu.config import Config, Data
    from nimble_tpu.index.builder import build_index
    from nimble_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)

    def mk_lib(n, seed):
        r = np.random.default_rng(seed)
        backbone = rand_seq(r, 400)
        data = Data()
        for i in range(n):
            s = list(backbone)
            for pos in r.integers(0, 400, size=12):
                s[pos] = "ACGT"[r.integers(0, 4)]
            data.columns[0].append("lib")
            data.columns[1].append(f"f{seed}_{i}")
            data.columns[2].append("400")
            data.columns[3].append("".join(s))
        cfg = Config(score_threshold=0, score_filter=0, score_percent=0.0)
        return build_index(data, cfg, k=21), cfg, data

    ix1, c1, d1 = mk_lib(20, 101)
    ix2, c2, d2 = mk_lib(12, 202)

    reads = []
    for i in range(64):
        src = (d1 if i % 2 else d2).sequences[i % 12]
        start = int(rng.integers(0, 300))
        reads.append(src[start : start + 80])
    codes, lens = seqmod.encode_batch(reads, 80)

    base = StackedEngine([ix1, ix2], [c1, c2], chunk_size=64, max_len=80)
    ref = base.align_batch_async(codes, lens)
    ref_outs = base.collect_async(ref)

    plan = make_mesh(n_data=8, n_feature=1)
    meshed = StackedEngine([ix1, ix2], [c1, c2], chunk_size=64, max_len=80, mesh=plan)
    got_outs = meshed.collect_async(meshed.align_batch_async(codes, lens))

    for r, g in zip(ref_outs, got_outs):
        for key in ("score", "pass_", "bits"):
            assert np.array_equal(r[key], g[key]), key

    with pytest.raises(ValueError):
        StackedEngine([ix1, ix2], [c1, c2], mesh=make_mesh(n_data=4, n_feature=2))


def test_report_device_and_distributed_match_host(workspace, tmp_path):
    """report --device and --distributed N produce the host path's output."""
    root = workspace["root"]
    results = os.path.join(root, "rep_in.tsv")
    # build a report input with shared UMIs and ambiguity via align
    assert cli([
        "align", "--reference", workspace["library"], "--output", results,
        "--input", workspace["fastq"], "--chunk-size", "32",
    ]) == 0
    # graft cb/umi columns onto the bulk TSV so report has groups to chew on
    with open(results) as f:
        lines = f.read().strip().split("\n")
    header = lines[0].split("\t")
    icb, iub = header.index("r1_CB"), header.index("r1_UB")
    rows = []
    for i, line in enumerate(lines[1:]):
        parts = line.split("\t")
        parts[icb] = f"CELL{i % 4}"
        parts[iub] = f"UMI{i % 7}"
        rows.append("\t".join(parts))
    tagged = str(tmp_path / "tagged.tsv")
    with open(tagged, "w") as f:
        f.write("\n".join([lines[0]] + rows) + "\n")

    host_out = str(tmp_path / "host.tsv")
    dev_out = str(tmp_path / "dev.tsv")
    dist_out = str(tmp_path / "dist.tsv")
    assert cli(["report", "-i", tagged, "-o", host_out]) == 0
    assert cli(["report", "-i", tagged, "-o", dev_out, "--device"]) == 0
    assert cli(["report", "-i", tagged, "-o", dist_out, "--distributed", "4"]) == 0
    host = read_lines(host_out)
    assert host  # non-empty counts
    assert read_lines(dev_out) == host
    assert read_lines(dist_out) == host
