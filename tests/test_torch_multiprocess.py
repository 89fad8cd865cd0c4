"""The port's ``parallel/`` across two real processes on the CPU (gloo).

The counterpart of ``tests/test_multiprocess.py``.  Two ranks of
``tests/torch_parallel_worker.py`` are spawned once for the module and
run every world-of-two case; ``python -m ...parallel.run_multihost`` runs
as two processes and as one.  The tests hold what the ranks wrote against
one process:

* the fused sweep equals the summed single-process K3-twin calls on
  ``device_seeds(seed, step, 2)``, stopped by the same error budget;
* ``rung="xla"`` with two ranks of b frames equals one process at 2b: the
  ranks draw one global sample and decode their halves, and the decoders
  work row by row, so the counters are equal;
* both OSD steps on 15 rows (8 and 7 a rank), and the trajectory step on
  one row (none on rank 1), equal JAX's counters;
* the train step equals the single-device update (loss rtol 1e-6,
  parameters 1e-5: the ranks sum the loss and the gradients in another
  order), and that update equals JAX's on the same frames (loss rtol 1e-5:
  the two dense decoders and their f32 sums of 6 x 32 x 128 loss terms
  round in other orders, 1.3e-6 apart here; parameters 1e-5);
* ``sharded_seed_counters`` sums each rank's counters.

Counters are compared exactly.  The workers block JAX from import.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.parallel import device_seeds
from short_ldpc_decoding_osd_tpu_torch.utils.metrics import DecodeStats
from torch_parallel_common import (jax_osd_counters, jax_osd_from_llr_counters,
                                   jax_train_reference, osd_inputs,
                                   port_train_reference)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
CASES = {
    "fused": dict(num_iterations=8, snr_db=3.0, batch=256, error_budget=100,
                  seed=3),
    "xla": dict(num_iterations=6, snr_db=2.5, batch=64, max_frames=256,
                seed=5),
    "train": dict(num_iterations=6, snr_db=2.7, per_device_batch=16, steps=2,
                  seed=13),
    "seeds": dict(base_seed=11, idx=4),
}
OSD_ROWS = 15
MULTIHOST = ["-m", "short_ldpc_decoding_osd_tpu_torch.parallel.run_multihost",
             "--device", "cpu", "--mesh-rung", "xla", "--snrs", "2.5:2.5:1",
             "--error-budget", "1000000", "--max-frames", "512",
             "--iterations", "4"]
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two worker ranks, the two-process ``run_multihost`` and
    the one-process one together; wait for all; return what they wrote."""
    work = tmp_path_factory.mktemp("ranks")
    inputs = osd_inputs(OSD_ROWS) | CASES
    with open(work / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    port, mh_port = _free_port(), _free_port()
    procs = [_spawn([WORKER, str(r), "2", str(port), str(work)])
             for r in range(2)]
    procs += [_spawn([*MULTIHOST, "--coordinator", f"127.0.0.1:{mh_port}",
                      "--num-processes", "2", "--process-id", str(r),
                      "--per-device-batch", "64", "--out",
                      str(work / "two.json")]) for r in range(2)]
    procs.append(_spawn([*MULTIHOST, "--per-device-batch", "128", "--out",
                         str(work / "one.json")]))
    try:
        outputs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"{p.args} failed:\n{out[-3000:]}"
    result = {"inputs": inputs}
    for name in ("rank0", "rank1", "two", "one"):
        with open(work / f"{name}.json") as fh:
            result[name] = json.load(fh)
    return result


def _stats(c) -> DecodeStats:
    return DecodeStats(int(c[0]), int(c[1]), int(c[2]), 128, int(c[3]),
                       int(c[4]))


def test_ranks_agree_and_import_no_jax(runs):
    r0, r1 = runs["rank0"], runs["rank1"]
    assert (r0["size"], r0["rank"], r1["rank"]) == (2, 0, 1)
    assert r0["jax_blocked"] and r1["jax_blocked"]
    assert {k: v for k, v in r0.items() if k != "rank"} == {
        k: v for k, v in r1.items() if k != "rank"}


def test_fused_sweep_equals_summed_k3_calls(runs):
    f = CASES["fused"]
    code, p = get_code("ccsds_128_64"), nms.init_params("NMS-1")
    want, idx = DecodeStats(bits_per_frame=code.n), 0
    while want.frame_errors <= f["error_budget"]:
        c = sum(nms_edge.fused_counters_edge_compact(
            code, p, "NMS-1", f["num_iterations"], f["snr_db"], f["batch"],
            seed=int(s), block_frames=256,
            schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device="cpu").numpy()
            for s in device_seeds(f["seed"], idx, 2))
        assert c[5] == 0  # no overflow: every step stays on K3
        want, idx = want.merge(_stats(c)), idx + 1
    assert idx >= 2
    assert DecodeStats(**runs["rank0"]["fused"]) == want


def test_xla_rung_two_ranks_equal_one_process(runs):
    x = CASES["xla"]
    one, _ = harness.run_nms_mc(
        get_code("ccsds_128_64"), nms.init_params("NMS-1"), "NMS-1",
        x["num_iterations"], x["snr_db"], batch=2 * x["batch"],
        max_frames=x["max_frames"], seed=x["seed"], rung="xla", device="cpu")
    assert one.frames == x["max_frames"]
    assert DecodeStats(**runs["rank0"]["xla"]) == one


def test_osd_steps_uneven_batch_equal_jax(runs):
    inp, got = runs["inputs"], runs["rank0"]
    assert got["osd"]["dtype"] == got["osd_from_llr"]["dtype"] == "torch.int64"
    np.testing.assert_array_equal(got["osd"]["counters"],
                                  jax_osd_counters(inp, sharded=False))
    one_row = inp | {"traj": inp["traj"][:1], "labels": inp["labels"][:1]}
    np.testing.assert_array_equal(got["osd_one_row"],
                                  jax_osd_counters(one_row, sharded=False))
    want = jax_osd_from_llr_counters(inp, sharded=False)
    assert want[0] == OSD_ROWS and want[1] > 0
    np.testing.assert_array_equal(got["osd_from_llr"]["counters"], want)


@pytest.mark.parametrize("variant", ["NMS-1", "ENMS"])
def test_train_step_equals_single_device_and_jax(runs, variant):
    t = CASES["train"]
    seeds = [t["seed"] + i for i in range(t["steps"])]
    losses, trail, frames = port_train_reference(
        variant, t["num_iterations"], t["snr_db"], 2 * t["per_device_batch"],
        seeds)
    got = runs["rank0"][f"train_{variant}"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    for mesh_params, params in zip(got["params"], trail):
        for k, v in params.items():
            np.testing.assert_allclose(mesh_params[k], v, rtol=1e-5, atol=1e-7)
    jax_losses, jax_trail = jax_train_reference(variant, t["num_iterations"],
                                                frames)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    for params, jparams in zip(trail, jax_trail):
        for k, v in params.items():
            np.testing.assert_allclose(v, jparams[k], rtol=1e-5, atol=1e-7)


def test_seed_counters_sum_over_ranks(runs):
    s = CASES["seeds"]
    seeds = device_seeds(s["base_seed"], s["idx"], 2).astype(np.int64)
    got = runs["rank0"]["seed_counters"]
    assert got["dtype"] == "torch.int64"
    assert got["counters"] == [int((seeds % 7).sum()), 2, int(seeds.sum())]


def test_run_multihost_two_processes_equal_one(runs):
    two, one = runs["two"]["points"][0], runs["one"]["points"][0]
    assert (two["devices"], two["hosts"]) == (2, 2)
    assert (one["devices"], one["hosts"]) == (1, 1)
    for field in ("frames", "frame_errors", "bit_errors", "detected_failures",
                  "undetected_errors"):
        assert two[field] == one[field], (field, two[field], one[field])
    assert two["frames"] == 512

