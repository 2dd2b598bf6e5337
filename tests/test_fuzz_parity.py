"""Randomized end-to-end parity vs the reference binary (tools/fuzz_parity).

Each case: random records/format/container + random flag set, byte-diffed
against a locally built reference ntcard. Alternates single-device (quad
wire) and 8-virtual-device (sharded) runs. A handful of seeds here; the
standalone tool runs arbitrarily many."""

import shutil
import tempfile
from pathlib import Path

import pytest

from tools.fuzz_parity import build_reference, run_case, run_case_nthll, stop_daemon

REF = Path("/tmp/ntcard_bench/ntcard_ref")
REF_HLL = Path("/tmp/ntcard_bench/nthll_ref")


@pytest.fixture(scope="module")
def ref_exe():
    if not build_reference(REF):
        pytest.skip("reference binary unavailable")
    yield REF
    stop_daemon()  # seeds with seed%4==1 route through the daemon arm


@pytest.mark.parametrize("seed", [101, 102, 103, 104])
def test_fuzz_case(ref_exe, seed):
    work = Path(tempfile.mkdtemp(prefix="ntcard_fuzz_test_"))
    try:
        msg = run_case(seed, ref_exe, work)
        assert msg is None, msg
    finally:
        shutil.rmtree(work, ignore_errors=True)


@pytest.mark.parametrize("seed", [201, 202])
def test_fuzz_nthll_case(seed):
    if not build_reference(REF_HLL, "nthll.cpp"):
        pytest.skip("reference nthll unavailable")
    work = Path(tempfile.mkdtemp(prefix="ntcard_fuzz_hll_"))
    try:
        msg = run_case_nthll(seed, REF_HLL, work)
        assert msg is None, msg
    finally:
        shutil.rmtree(work, ignore_errors=True)


def test_mixed_format_klarge_at_list(ref_exe, tmp_path):
    """BASELINE config-5 shape (single-host slice): fa + fq.gz + sam via an
    @-list at k=144 (long-k window), byte-parity with the reference."""
    import gzip
    import os
    import subprocess
    import sys

    rng = __import__("random").Random(9)

    def seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    fa = tmp_path / "a.fa"
    fa.write_text("".join(f">c{i}\n{seq(rng.randrange(100, 400))}\n" for i in range(120)))
    fq = tmp_path / "b.fq.gz"
    body = "".join(
        "@r%d\n%s\n+\n%s\n" % (i, s, "I" * len(s))
        for i, s in ((i, seq(rng.randrange(120, 300))) for i in range(150))
    )
    fq.write_bytes(gzip.compress(body.encode()))
    sam = tmp_path / "c.sam"
    sam.write_text(
        "@HD\tVN:1.6\n"
        + "".join(
            f"r{i}\t0\tc\t1\t60\t*\t*\t0\t0\t{seq(rng.randrange(150, 250))}\t*\n"
            for i in range(100)
        )
    )
    lst = tmp_path / "lib.in"
    lst.write_text(f"{fa}\n{fq}\n{sam}\n")

    flags = ["-k144", "-c64", "-r14"]
    subprocess.run(
        [str(ref_exe)] + flags + ["-p", str(tmp_path / "ref"), f"@{lst}"],
        check=True, capture_output=True, timeout=300,
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, "-m", "ntcard_tpu.cli"] + flags
        + ["-p", str(tmp_path / "ours"), f"@{lst}"],
        check=True, capture_output=True, timeout=600, env=env,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert (tmp_path / "ref_k144.hist").read_bytes() == (tmp_path / "ours_k144.hist").read_bytes()
