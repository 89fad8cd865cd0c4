"""The multi-code recipe on the port vs the JAX package (CPU).

``pipeline/multicode.py`` is the port's counterpart of
``scripts/multicode_recipe.py``.  Its records are the JAX runs under
``runs/r5_multicode/<code>/`` (NMS-1, 12 iterations, ``model_cnn``,
``threshold_sum`` 3, ``decoding_length`` 30, window 5, soft margin 0.9, 6
segments).  For each of the four rate-1/2 codes the port's raw-LLR phase-2
step runs against JAX's (``decoder="xla"``) on 48 seeded failure rows with
the record's own artifacts: ``array_121_60`` decodes on its rank-deficient
66-row H and runs OSD on its 61-row ``h_osd``; ``regular_256_128`` is built
in code.  The full path runs for three codes; ``wimaxlike_384_192``'s path
(58,132 TEPs) is cut to its first 15 patterns (1,440 TEPs), since the CPU
twin of K5 builds the (B, m, N) parity tensor.

Tolerances: walk decisions and detected flags exact; the DIA on JAX's
trajectory within rtol 1e-5 / atol 1e-6; the step's refined values within
``STEP_TOL`` = 1e-4 (K2's twin and JAX's XLA decoder sum in other orders;
the largest difference measured on these rows is 8.0e-5, at n = 384).
"""

import ast
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu.pipeline import recipe as jrecipe
from short_ldpc_decoding_osd_tpu_torch.pipeline import multicode
from torch_phase2_common import (assert_phase2_matches, failures_first,
                                 load_case, seeded_rows)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(_ROOT, "scripts", "multicode_recipe.py")
STEP_TOL = 1e-4
# code -> (SNR of the rows, patterns of the path kept (None: all), TEPs)
CODES = {
    "qc_96_48": (2.5, None, 827),
    "array_121_60": (2.5, None, 1_516),
    "regular_256_128": (2.5, None, 8_010),
    "wimaxlike_384_192": (2.0, 15, 1_440),
}


@pytest.mark.parametrize("name", list(CODES))
def test_phase2_matches_jax(name):
    """48 seeded failure rows of each code through the port's phase-2 step
    and JAX's: decisions and detected flags equal, refined values within
    the stated tolerances."""
    snr, cut, n_teps = CODES[name]
    case = load_case(os.path.join(_ROOT, "runs", "r5_multicode", name), cut)
    assert int(case["mask"].sum()) == n_teps
    code = case["port"]["code"]
    if name == "array_121_60":  # decoded on the raw H, OSD on its basis
        assert code.h.shape == (66, 121) and code.h_osd.shape == (61, 121)
    llr, words = seeded_rows(code, snr, 512, 7)
    llr, words, failures = failures_first(case["port"], llr, words, 48)
    assert failures == 48
    detected, err = assert_phase2_matches(case, llr, words, STEP_TOL)
    assert detected == 48 and err < STEP_TOL


def _script_plans():
    """``PLANS`` of ``scripts/multicode_recipe.py``, read from its source
    (importing the script would set JAX's compilation-cache options)."""
    with open(SCRIPT) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "PLANS":
            value = node.value
            return {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                          for kw in v.keywords}
                    for k, v in zip(value.keys, value.values)}
    raise AssertionError("no PLANS in the script")


def test_plans_equal_the_script():
    assert multicode.PLANS == _script_plans()
    assert list(multicode.PLANS) == list(_script_plans())


def _script_calls(monkeypatch, argv):
    """The (config, run root, points) the JAX script passes to its
    ``run_recipe`` for ``argv``: its ``main`` run with ``run_recipe``
    recorded and ``jax.config.update`` a no-op."""
    with open(SCRIPT) as fh:
        source = fh.read()
    calls = []

    def record(cfg, root, points, log=print):
        calls.append((cfg, root, np.asarray(points)))
        return {"points": [{"snr_db": float(s), "fer_nms_detected": 0.5,
                            "fer_osd": 0.25, "fer_total": 0.125, "frames": 64}
                           for s in points]}

    stub = types.ModuleType("jax")
    stub.config = types.SimpleNamespace(update=lambda *args: None)
    namespace = {"__name__": "multicode_recipe_under_test", "__file__": SCRIPT}
    with monkeypatch.context() as patch:
        patch.setitem(sys.modules, "jax", stub)
        exec(compile(source, SCRIPT, "exec"), namespace)
    namespace["run_recipe"] = record
    monkeypatch.setattr(sys, "argv", ["multicode_recipe.py"] + argv)
    namespace["main"]()
    return calls


def test_main_builds_the_scripts_configs(monkeypatch, tmp_path):
    """``main(["--codes", ..., "--quick", ...])`` passes ``run_recipe`` the
    ``RecipeConfig``, run directory and SNR points the JAX script does, and
    writes the same ``summary.json``; a second call merges its codes into
    the file."""
    calls = []

    def record(cfg, root, points, log=print, device="cuda"):
        calls.append((cfg, root, np.asarray(points), device))
        return {"points": [{"snr_db": float(s), "fer_nms_detected": 0.5,
                            "fer_osd": 0.25, "fer_total": 0.125, "frames": 64,
                            "osd": {}} for s in points]}

    monkeypatch.setattr(multicode, "run_recipe", record)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    args = ["--codes", "qc_96_48,array_121_60", "--quick"]
    multicode.main(args + ["--out-root", str(port_root), "--device", "cpu"])
    want = _script_calls(monkeypatch, args + ["--out-root", str(jax_root)])
    assert len(calls) == len(want) == 2
    for (cfg, root, points, device), (jcfg, jroot, jpoints) in zip(calls, want):
        assert isinstance(jcfg, jrecipe.RecipeConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert os.path.relpath(root, port_root) == os.path.relpath(jroot, jax_root)
        np.testing.assert_array_equal(points, jpoints)
        assert str(device) == "cpu"
    assert calls[0][0].nms_error_budget == 500 and calls[1][0].osd_failure_budget == 30

    def summary(root):
        with open(root / "summary.json") as fh:
            blob = json.load(fh)
        for entry in blob.values():
            entry.pop("elapsed_s")
        return blob

    assert summary(port_root) == summary(jax_root)
    multicode.main(["--codes", "wimaxlike_384_192", "--out-root", str(port_root),
                    "--device", "cpu"])
    assert list(summary(port_root)) == ["qc_96_48", "array_121_60",
                                        "wimaxlike_384_192"]
    assert calls[-1][0].nms_error_budget == 8000 and calls[-1][0].seed == 0
    np.testing.assert_array_equal(calls[-1][2], [1.5, 2.0, 2.5])
