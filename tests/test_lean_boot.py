"""Lean-boot invariants: the host-engine CLI path must never import jax
(its import alone costs ~2.5 s — material next to a sub-second host run),
and the package root must stay jax-free so `import ntcard_tpu` is cheap.

The launchers (bin/ntcard, bin/nthll) run ``python -m`` with the checkout
on PYTHONPATH and nothing else; the device path imports jax lazily.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"


def _run_py(code: str, env_extra: dict) -> subprocess.CompletedProcess:
    # the checkout alone on PYTHONPATH, exactly what the launchers set
    env = dict(os.environ, PYTHONPATH=str(REPO), **env_extra)
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        cwd=str(REPO),
        env=env,
        timeout=120,
    )


def test_host_cli_never_imports_jax(tmp_path):
    code = (
        "import sys\n"
        "from ntcard_tpu.cli import main\n"
        f"rc = main(['-k12', '-c8', '-r12', '-p', '{tmp_path}/o', "
        f"'{DATA / 'reads.fq'}'])\n"
        "assert rc == 0\n"
        "assert 'jax' not in sys.modules, 'host path imported jax'\n"
        "print('LEAN_OK')\n"
    )
    r = _run_py(code, {"NTCARD_ENGINE": "host", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert "LEAN_OK" in r.stdout


def test_host_cli_hll_never_imports_jax(tmp_path):
    code = (
        "import sys\n"
        "from ntcard_tpu.cli_hll import main\n"
        f"rc = main(['-k25', '{DATA / 'reads.fq'}'])\n"
        "assert rc == 0\n"
        "assert 'jax' not in sys.modules, 'host hll path imported jax'\n"
        "print('LEAN_OK')\n"
    )
    r = _run_py(code, {"NTCARD_ENGINE": "host", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert "LEAN_OK" in r.stdout


def test_package_root_is_jax_free():
    code = (
        "import sys\n"
        "import ntcard_tpu\n"
        "import ntcard_tpu.io.packing, ntcard_tpu.io.readers\n"
        "import ntcard_tpu.models.host_engine, ntcard_tpu.models.estimate\n"
        "import ntcard_tpu.output, ntcard_tpu.pipeline\n"
        "assert 'jax' not in sys.modules\n"
        "print('LEAN_OK')\n"
    )
    r = _run_py(code, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert "LEAN_OK" in r.stdout


def test_launcher_runs_host_engine(tmp_path):
    r = subprocess.run(
        [
            str(REPO / "bin" / "ntcard"),
            "-k12", "-c8", "-r12", "-p", str(tmp_path / "o"),
            str(DATA / "reads.fq"),
        ],
        capture_output=True,
        text=True,
        env=dict(os.environ, NTCARD_ENGINE="host", JAX_PLATFORMS="cpu",
                 NTCARD_PYTHON=sys.executable),
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "o_k12.hist").exists()
