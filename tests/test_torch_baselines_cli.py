"""``sldpc-torch baseline`` (CPU) against the JAX package's ``sldpc
baseline`` on one failure cache: the port captures the NMS failures of a
tiny run directory once and writes ``baseline_failures_*.{npz,json}``
under JAX's key; JAX's CLI reads that cache (it does not capture again)
and both write byte-identical ``baseline_{kind}.json`` for every kind."""

import importlib
import os
import shutil

import pytest

from short_ldpc_decoding_osd_tpu_torch.cli.main import main as cli_main

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

# the module (the package's ``cli`` re-exports its ``main`` function)
jax_cli = importlib.import_module("short_ldpc_decoding_osd_tpu.cli.main")

ARGS = ["--code", "code1_64_32", "--order", "2", "--failure-budget", "4",
        "--batch", "256", "--snrs", "2.0:3.0:2"]
CACHE = [f"baseline_failures_{snr}dB.{ext}" for snr in ("2.00", "3.00")
         for ext in ("npz", "json")]


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """(port run dir, JAX run dir, cache stamps): the port's capture, its
    cache copied into a second directory for JAX."""
    port_dir = tmp_path_factory.mktemp("port")
    jax_dir = tmp_path_factory.mktemp("jax")
    assert cli_main(["baseline", "--kind", "miracle", "--device", "cpu",
                     "--run-dir", str(port_dir)] + ARGS) == 0
    for name in CACHE:
        shutil.copy2(port_dir / name, jax_dir / name)
    stamps = {name: os.stat(jax_dir / name).st_mtime_ns for name in CACHE}
    return port_dir, jax_dir, stamps


@pytest.mark.parametrize("kind", ["miracle", "fs", "pb", "conventional"])
def test_baseline_cli_matches_jax(run_dirs, kind, monkeypatch, capsys):
    port_dir, jax_dir, stamps = run_dirs
    # JAX's CLI would point its persistent compile cache into the repo
    monkeypatch.setattr(jax_cli, "_setup_compile_cache", lambda: None)
    assert cli_main(["baseline", "--kind", kind, "--device", "cpu",
                     "--run-dir", str(port_dir)] + ARGS) == 0
    assert jax_cli.main(["baseline", "--kind", kind, "--run-dir", str(jax_dir)]
                        + ARGS) == 0
    capsys.readouterr()
    name = f"baseline_{kind}.json"
    got = (port_dir / name).read_bytes()
    assert got == (jax_dir / name).read_bytes()
    assert b'"note"' not in got  # every point had failures to decode
    # JAX read the port's cache instead of capturing its own
    assert {n: os.stat(jax_dir / n).st_mtime_ns for n in CACHE} == stamps
