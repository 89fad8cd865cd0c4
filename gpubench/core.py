"""One run of one cell: find its files by name, check the device, drive
the kind's loop, read the metrics, judge the checked units and print the
result line.

The last line of standard output is one JSON object with ``correct``,
``attempted`` (units the run timed), ``failed`` (checked units with a
number over its limit), ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each judged number with its limit.
The same numbers end standard error, one a line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
import types

# what may not be loaded in the process that prints the result: JAX, its
# libraries and the JAX package, compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "short_ldpc_decoding_osd_tpu")
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


class SpecError(Exception):
    """A cell, file or metric that the benchmark cannot find."""


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(root: str, name: str) -> types.SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json``: its workload entry, its
    configuration, traffic and check files, and the metrics it reports."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    work = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[work["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", work["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "checks", name + ".json"))

    def reports(metric):
        return metric.get("workloads") is None or name in metric["workloads"]

    end_to_end = [m for m in spec["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return types.SimpleNamespace(name=name, chips=int(work["chips"]),
                                 config=config, traffic=traffic,
                                 limits=limits, end_to_end=end_to_end,
                                 per_layer=per_layer)


def _load(path: str, module_name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no reader {path}")
    return _load(path, "gpubench.metrics." + name.replace(".", "_")).read


def decoder(variant: str) -> types.ModuleType:
    """The module of ``reference/variants/<variant>.py``: the judge's view
    of the configuration's phase-1 decoder (``reference/setup.py`` lists
    what it holds)."""
    path = os.path.join(BENCH_DIR, "reference", "variants", variant + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no decoder {path} for the variant {variant!r}")
    return _load(path, "gpubench.reference.variants."
                 + re.sub(r"[.-]", "_", variant))


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def judge(per_unit: list[dict], limits: dict):
    """(checks {name: {value, limit}}, failed units): each number is the
    largest over the checked units; a unit fails when any of its numbers
    exceeds its limit or has no limit."""
    failed = 0
    worst: dict[str, float] = {}
    for nums in per_unit:
        failed += any(name not in limits or value > limits[name]
                      for name, value in nums.items())
        for name, value in nums.items():
            worst[name] = max(worst.get(name, value), value)
    checks = {name: {"value": worst[name], "limit": limits.get(name)}
              for name in sorted(worst)}
    return checks, failed


def read_metrics(specs: list[dict], ctx) -> dict:
    """``{name: {value, unit}}`` of the metrics ``specs`` whose readers
    find something to read in ``ctx``."""
    metrics = {}
    for m in specs:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, traffic: dict | None = None) -> dict:
    """Run the cell and return the result line as a dict.  ``device`` None
    asks for the card (and fails without one); the tests pass the CPU and
    ``traffic`` keys that shrink the cell to a test's size."""
    import torch

    from . import trace as trace_mod

    cell = find_cell(root, name)
    cell.traffic.update(traffic or {})
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(
                f"cell {name} needs {cell.chips} CUDA device(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"device_count() is {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    kind = importlib.import_module(f"gpubench.kinds.{cell.traffic['kind']}")
    run_args = types.SimpleNamespace(
        root=root, name=name, seed=seed, seconds=seconds, t_start=t_start,
        device=device, config=cell.config, traffic=cell.traffic)
    tracer = trace_mod.Tracer(trace, os.path.join(root, "build", "gpubench",
                                                  "trace.json"))
    res = kind.run(run_args, tracer)
    summary = tracer.summary() if trace else None
    # the readers see everything the kind returned, so a new metric needs
    # only its own file
    ctx = types.SimpleNamespace(**res, kind=cell.traffic["kind"], trace=summary,
                                traffic=cell.traffic, config=cell.config)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    checks, failed = judge(res["per_unit"], cell.limits)
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(res["memory_peak_bytes"]),
    }
    line = {"correct": failed == 0, "attempted": res["ran"],
            "failed": failed, "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        line["breakdown"] = summary["breakdown"]
    # what the checked units counted; rows whose walk differed from the
    # reference's only at a near-tie
    for note in res["work"]["notes"]:
        print(note, file=sys.stderr, flush=True)
    if summary is not None:
        print(f"trace file {summary['trace_bytes']} bytes", file=sys.stderr,
              flush=True)
    if "walk_ties" in res["work"]:
        print(f"walk ties {res['work']['walk_ties']}", file=sys.stderr, flush=True)
    line["checks"] = checks  # last in the line
    return line


def main(args, t_start: float) -> int:
    root = os.path.dirname(BENCH_DIR)
    line = run_cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print("loaded in the result's process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
