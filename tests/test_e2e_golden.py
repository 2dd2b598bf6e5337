"""End-to-end golden parity: the CLI must byte-match histograms produced by
the reference binary (tests/golden/, regenerated by regen.sh). Mirrors the
reference's six-way `make check` matrix (reference Makefile.am:65-83) plus
multi-k, long-contig, compact and multi-file cases."""

import gzip
import shutil
from pathlib import Path

import pytest

from ntcard_tpu import cli

DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"


def run(tmp_path, args):
    rc = cli.main([str(a) for a in args])
    assert rc == 0
    return tmp_path


def assert_match(out: Path, good: str):
    assert out.read_bytes() == (GOLD / good).read_bytes()


@pytest.mark.parametrize("src", ["reads.fq", "reads-rna.fq", "reads.fa", "reads.sam"])
def test_k12_format_matrix(tmp_path, src):
    run(tmp_path, ["-k12", "-c1000", "-r16", "-p", tmp_path / "t", DATA / src])
    assert_match(tmp_path / "t_k12.hist", "reads_k12.hist.good")


@pytest.mark.parametrize("src", ["reads.fq", "reads-rna.fq", "reads.fa"])
def test_k12_gap(tmp_path, src):
    """The reference's full six-way golden matrix is {dna-fastq, rna-fastq,
    fasta} x {plain, gap} (Makefile.am:65-83, SURVEY §4); RNA and FASTA must
    be byte-identical to the DNA gap golden (U≡T, format independence)."""
    run(tmp_path, ["-k12", "-c1000", "-r16", "-g2", "-p", tmp_path / "t", DATA / src])
    assert_match(tmp_path / "t_k12.hist", "reads-gap_k12.hist.good")


def test_multi_k(tmp_path):
    run(tmp_path, ["-k32,64,96", "-c64", "-r16", "-p", tmp_path / "m", DATA / "reads.fq"])
    for k in (32, 64, 96):
        assert_match(tmp_path / f"m_k{k}.hist", f"reads_k{k}.hist.good")


def test_long_contig(tmp_path):
    run(tmp_path, ["-k25,96", "-c64", "-r16", "-p", tmp_path / "c", DATA / "contig.fa"])
    assert_match(tmp_path / "c_k25.hist", "contig_k25.hist.good")
    assert_match(tmp_path / "c_k96.hist", "contig_k96.hist.good")


def test_compact_tsv(tmp_path, capsys):
    run(tmp_path, ["-k12,32", "-c64", "-r16", "-o", tmp_path / "out.tsv", DATA / "reads.fq"])
    assert_match(tmp_path / "out.tsv", "reads_compact.tsv.good")
    err = capsys.readouterr().err
    klines = "".join(l + "\n" for l in err.splitlines() if l.startswith("k="))
    assert klines == (GOLD / "reads_compact.stderr.good").read_text()


def test_multi_file(tmp_path):
    run(
        tmp_path,
        ["-k12", "-c1000", "-r16", "-p", tmp_path / "b", DATA / "reads.fq", DATA / "contig.fa"],
    )
    assert_match(tmp_path / "b_k12.hist", "both_k12.hist.good")


def test_default_r27(tmp_path):
    """DEFAULT rBits=27 (no -r flag; reference ntcard.cpp:60) — the
    configuration every real user runs. Covers the 2^27-bucket table and the
    native-histogram finalize path (--devices 1: the single-chip layout; the
    8-virtual-device sharded variant at r27 would allocate 8 GiB of private
    tables in this CPU test env)."""
    run(tmp_path, ["-k12", "-c1000", "--devices", "1", "-p", tmp_path / "d", DATA / "reads.fq"])
    assert_match(tmp_path / "d_k12.hist", "reads_r27_k12.hist.good")


def test_gzip_input(tmp_path):
    gz = tmp_path / "reads.fq.gz"
    with open(DATA / "reads.fq", "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    run(tmp_path, ["-k12", "-c1000", "-r16", "-p", tmp_path / "z", gz])
    assert_match(tmp_path / "z_k12.hist", "reads_k12.hist.good")


def test_at_file_list(tmp_path):
    lst = tmp_path / "files.txt"
    lst.write_text(f"{DATA / 'reads.fq'}\n")
    run(tmp_path, ["-k12", "-c1000", "-r16", "-p", tmp_path / "l", "@" + str(lst)])
    assert_match(tmp_path / "l_k12.hist", "reads_k12.hist.good")


def test_unknown_format_errors(tmp_path, capsys):
    bad = tmp_path / "bad.txt"
    bad.write_text("this is not a sequence file\n")
    with pytest.raises(SystemExit) as e:
        cli.main(["-k12", "-r16", "-p", str(tmp_path / "x"), str(bad)])
    assert e.value.code == 1
    assert "Error in reading file" in capsys.readouterr().err


def test_nthll_golden(capsys):
    from ntcard_tpu import cli_hll

    rc = cli_hll.main(["-k25", str(DATA / "reads.fq")])
    assert rc == 0
    out = capsys.readouterr().out
    assert out == (GOLD / "nthll_k25.out.good").read_text()


def test_validation_errors(capsys):
    # missing -k
    with pytest.raises(SystemExit):
        cli.main(["-p", "x", "f.fq"])
    # missing -p/-o
    with pytest.raises(SystemExit):
        cli.main(["-k12", "f.fq"])
    # gap parity
    with pytest.raises(SystemExit):
        cli.main(["-k12", "-g3", "-p", "x", "f.fq"])
    # gap with multiple k
    with pytest.raises(SystemExit):
        cli.main(["-k12,14", "-g2", "-p", "x", "f.fq"])
    capsys.readouterr()


def test_sketch_checkpoint_merge(tmp_path):
    """Two partial runs saved as sketches, merged offline, must byte-match
    the combined-run golden."""
    from ntcard_tpu.tools import merge_sketches

    run(tmp_path, ["-k12", "-c1000", "-r16", "-p", tmp_path / "x1",
                   "--save-sketch", tmp_path / "s1.npz", DATA / "reads.fq"])
    run(tmp_path, ["-k12", "-c1000", "-r16", "-p", tmp_path / "x2",
                   "--save-sketch", tmp_path / "s2.npz", DATA / "contig.fa"])
    rc = merge_sketches.main(
        ["-p", str(tmp_path / "m"), "-c", "1000", str(tmp_path / "s1.npz"), str(tmp_path / "s2.npz")]
    )
    assert rc == 0
    assert_match(tmp_path / "m_k12.hist", "both_k12.hist.good")


def test_sketch_merge_rejects_incompatible_configs(tmp_path):
    """Sketches with different spaced seeds or strides must refuse to merge —
    summing semantically incompatible tables would silently corrupt the
    histogram."""
    from ntcard_tpu.models.sketch import CountTableSketch

    base = CountTableSketch((12,), s_bits=7, r_bits=12, stride=240)
    gap = CountTableSketch((12,), s_bits=7, r_bits=12, stride=240, gap_positions=(5, 6))
    other_stride = CountTableSketch((12,), s_bits=7, r_bits=12, stride=480)
    with pytest.raises(ValueError):
        base.merge_(gap)
    with pytest.raises(ValueError):
        base.merge_(other_stride)
    # round-trips through save/load carry the config
    gap.save(str(tmp_path / "g.npz"))
    with pytest.raises(ValueError):
        base.merge_(CountTableSketch.load(str(tmp_path / "g.npz")))


def test_threads_flag_parallel_files(tmp_path):
    """-t N with multiple files: per-thread packers, commutative merge —
    histogram must still byte-match the combined-run golden."""
    run(tmp_path, ["-k12", "-c1000", "-r16", "-t2", "-p", tmp_path / "t2",
                   DATA / "reads.fq", DATA / "contig.fa"])
    assert_match(tmp_path / "t2_k12.hist", "both_k12.hist.good")


def test_empty_file_errors(tmp_path, capsys):
    """An empty input file is 'Error in reading file' + exit 1 (the
    reference's getftype sniffs the failed getline's empty string and lands
    on error, ntcard.cpp:105-130)."""
    empty = tmp_path / "empty.fq"
    empty.write_bytes(b"")
    with pytest.raises(SystemExit) as e:
        cli.main(["-k12", "-r10", "-p", str(tmp_path / "x"), str(empty)])
    assert e.value.code == 1
    assert "Error in reading file" in capsys.readouterr().err


def test_metrics_flag_emits_json(tmp_path, capsys):
    import json

    run(tmp_path, ["-k12", "-c64", "-r10", "--metrics", "-p", tmp_path / "m", DATA / "reads.fa"])
    err = capsys.readouterr().err
    line = next(l for l in err.splitlines() if l.startswith("{"))
    m = json.loads(line)
    assert {"total_sec", "phases_sec", "counters"} <= set(m)
    assert m["counters"]["reads"] == 20000
    # coarse phases always present; fine-grained pipeline.* stages (decode /
    # pack / h2d / dispatch) attribute the streaming loop
    assert {"pipeline", "finalize", "estimate", "output"} <= set(m["phases_sec"])
    assert {"pipeline.decode", "pipeline.pack", "pipeline.h2d", "pipeline.dispatch"} <= set(
        m["phases_sec"]
    )


def test_headerless_sam(tmp_path):
    """A SAM file with no @ header: the sniffer's 11-field numeric check
    (ntcard.cpp:116-129) routes it to the SAM reader with the first line as
    alignment #1 — output must still match the k=12 golden."""
    src = (DATA / "reads.sam").read_bytes().splitlines(keepends=True)
    body = b"".join(l for l in src if not l.startswith(b"@"))
    hs = tmp_path / "headerless.sam"
    hs.write_bytes(body)
    run(tmp_path, ["-k12", "-c1000", "-r16", "-p", tmp_path / "h", hs])
    assert_match(tmp_path / "h_k12.hist", "reads_k12.hist.good")


def test_geometry_independence(tmp_path):
    """Chunk/batch geometry must not affect the histogram (halo ownership
    makes every window counted exactly once)."""
    run(tmp_path, ["-k12", "-c1000", "-r16", "--chunk-len", "384",
                   "--batch-rows", "256", "-p", tmp_path / "g", DATA / "reads.fq"])
    assert_match(tmp_path / "g_k12.hist", "reads_k12.hist.good")


def test_profiler_hook(tmp_path, monkeypatch):
    """NTCARD_PROFILE=dir captures a jax.profiler trace of the device phase."""
    monkeypatch.setenv("NTCARD_PROFILE", str(tmp_path / "trace"))
    run(tmp_path, ["-k12", "-c64", "-r10", "-p", tmp_path / "p", DATA / "reads.fa"])
    produced = list((tmp_path / "trace").rglob("*"))
    assert produced, "no profiler output written"


def test_nthll_custom_bits(capsys):
    """Hidden -b/--bit register-width flag (nthll.cpp:161-163)."""
    from ntcard_tpu import cli_hll

    rc = cli_hll.main(["-k25", "-b10", str(DATA / "reads.fq")])
    assert rc == 0
    assert capsys.readouterr().out == (GOLD / "nthll_k25_b10.out.good").read_text()


def test_default_r27_host_route_knob(tmp_path, monkeypatch):
    """NTCARD_HOST_MIN_RBITS restores the round-2 auto->host routing for
    big-table runs on deployments whose link makes the host engine win
    (cli._use_host_engine; the default no longer routes r27 to the host —
    the round-3 device path beats the reference at the default config).
    Forcing the accelerator platform string is safe here because the host
    path never touches jax — the run only passes if the route engaged."""
    from ntcard_tpu.models.host_engine import host_engine_available

    if not host_engine_available():
        pytest.skip("no native toolchain")
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("NTCARD_HOST_MIN_RBITS", "20")
    monkeypatch.delenv("NTCARD_ENGINE", raising=False)
    run(tmp_path, ["-k12", "-c1000", "-p", tmp_path / "h", DATA / "reads.fq"])
    assert_match(tmp_path / "h_k12.hist", "reads_r27_k12.hist.good")


def test_fast_device_path_golden(tmp_path, monkeypatch):
    """The startup-overlapped single-device path (cli._main_device_fast:
    boot thread + eager feed + warm loads + fused finalize) must byte-match
    the golden. NTCARD_EAGER=1 opts the CPU platform in; --devices 1 pins
    the single-device branch on the 8-device test mesh."""
    monkeypatch.setenv("NTCARD_EAGER", "1")
    monkeypatch.setenv("NTCARD_FINALIZE", "fused")
    run(tmp_path, ["-k12", "-c1000", "-r16", "--devices", "1",
                   "-p", tmp_path / "t", DATA / "reads.fq"])
    assert_match(tmp_path / "t_k12.hist", "reads_k12.hist.good")


def test_fast_device_path_multidevice_fallback(tmp_path, monkeypatch):
    """Auto-detected multi-device mesh: the fast path abandons its eager
    single-device stream (EagerPrefetch.close) and re-runs the legacy
    sharded path — output must still byte-match."""
    monkeypatch.setenv("NTCARD_EAGER", "1")
    run(tmp_path, ["-k12", "-c1000", "-r16", "-p", tmp_path / "t", DATA / "reads.fq"])
    assert_match(tmp_path / "t_k12.hist", "reads_k12.hist.good")


def test_fast_device_path_multik_gap_and_save(tmp_path, monkeypatch):
    """Fast path with multi-k + save-sketch, and the gap-seed variant."""
    monkeypatch.setenv("NTCARD_EAGER", "1")
    run(tmp_path, ["-k12,14", "-c1000", "-r16", "--devices", "1",
                   "--save-sketch", tmp_path / "s.npz",
                   "-p", tmp_path / "m", DATA / "reads.fq"])
    assert_match(tmp_path / "m_k12.hist", "reads_k12.hist.good")
    assert (tmp_path / "s.npz").exists()
    run(tmp_path, ["-k12", "-c1000", "-r16", "-g2", "--devices", "1",
                   "-p", tmp_path / "g", DATA / "reads.fq"])
    assert_match(tmp_path / "g_k12.hist", "reads-gap_k12.hist.good")


def test_fast_device_path_nibble_fallback(tmp_path, monkeypatch):
    """An N-dense input overflows the quad2 sidecar and falls back to the
    nibble wire per batch — inside the fast path this is a second,
    un-warmed update signature. Fast and legacy paths must byte-match."""
    import numpy as np

    rng = np.random.default_rng(8)
    src = tmp_path / "ndense.fa"
    with open(src, "w") as f:
        for i in range(300):
            seq = rng.choice(list("ACGTN"), p=[0.175, 0.175, 0.175, 0.175, 0.3],
                             size=400)
            f.write(f">r{i}\n{''.join(seq)}\n")
    monkeypatch.setenv("NTCARD_EAGER", "1")
    run(tmp_path, ["-k12", "-c64", "-r16", "--devices", "1",
                   "-p", tmp_path / "fast", src])
    monkeypatch.setenv("NTCARD_EAGER", "0")
    run(tmp_path, ["-k12", "-c64", "-r16", "--devices", "1",
                   "-p", tmp_path / "legacy", src])
    assert (tmp_path / "fast_k12.hist").read_bytes() == (
        tmp_path / "legacy_k12.hist"
    ).read_bytes()


def test_nthll_metrics_env_emits_json(capsys, monkeypatch):
    """NTCARD_METRICS=1 gives nthll's device path the structured metrics
    line ntcard's --metrics prints (phase split), beside the golden F0."""
    import json

    from ntcard_tpu import cli_hll

    monkeypatch.setenv("NTCARD_METRICS", "1")
    assert cli_hll.main(["-k25", str(DATA / "reads.fq")]) == 0
    cap = capsys.readouterr()
    assert cap.out == (GOLD / "nthll_k25.out.good").read_text()
    line = next(l for l in cap.err.splitlines() if l.startswith("{"))
    assert {"pipeline", "finalize"} <= set(json.loads(line)["phases_sec"])
