"""The port's own spans in a traced window, and the per-layer readings
that would read them.

While ``utils.profiling.recording()`` is on, the port opens a
``torch.profiler.record_function`` range ``sldpc.<name>`` around each of
its stages and counts its OSD rows (``osd.rows``, ``osd.failures``).
:func:`reduce_program` reduces a chrome trace that holds them by the
launch correlation of ``trace.reduce_events``: for each span name its
calls, inclusive device seconds, self device seconds (launched inside it
and inside no child span), synchronising runtime calls made while it is
the innermost open span, and the device-idle seconds of the gaps that
start then; and what the device ran outside every span.

``reduce_events`` and the cells' readers do not use this yet: the
traced window would have to open ``recording()`` and add
``reduce_program``'s result to its summary, and the kinds the port's
counters to their results.  Until then a window with the spans runs as

    python3 gpubench/program.py --workload <name> --seed <n> --seconds <s> [--trace 0] [--cost TURNS]

which runs the cell as ``run.py`` does with the window recording, and
prints the run's line with, traced, the span table (on standard error),
the five readings of :data:`READINGS` and each span beside the
benchmark's range around the same call.  ``--trace 0 --cost TURNS``
instead alternates recording off and on in an untraced window and prints
the seconds a unit of each.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import roofline, trace  # noqa: E402

PREFIX = "sldpc."
# runtime calls that block the host until the device has drained
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# each program span beside the benchmark's range around the same call
SAME_CALL = (("capture", "capture_round"), ("phase2", "phase2"),
             ("redecode", "redecode"), ("dia", "dia"), ("prepare", "prepare"),
             ("minima", "minima"), ("walk", "walk"), ("mc.step", "phase1_step"))


class _Spans:
    """The window's program spans, properly nested on one thread: the
    innermost open at a time and its enclosing chain."""

    def __init__(self, events: list, w0: float, w1: float):
        found = sorted(
            ((float(e["ts"]), -float(e["dur"]), e["name"][len(PREFIX):])
             for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)
             and w0 <= float(e["ts"]) <= w1), key=lambda x: (x[0], x[1]))
        self.starts = [s for s, _, _ in found]
        self.ends = [s - d for s, d, _ in found]
        self.names = [n for _, _, n in found]
        self.parent = []
        open_ = []
        for i, (s, e) in enumerate(zip(self.starts, self.ends)):
            while open_ and self.ends[open_[-1]] < s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def innermost(self, t: float) -> int:
        """Index of the innermost span open at ``t``, -1 outside all."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return i

    def chain(self, i: int) -> set[str]:
        """The names of span ``i`` and of every span enclosing it."""
        names = set()
        while i >= 0:
            names.add(self.names[i])
            i = self.parent[i]
        return names


def reduce_program(events: list) -> dict:
    """``{"spans": {name: {calls, seconds, self_seconds, syncs, idle_s}},
    "outside_s", "outside_syncs", "outside_idle_s", "device_s",
    "sync_sites"}`` of the window's ``sldpc.*`` spans (seconds of the
    device; ``device_s`` all the device time in the window; ``sync_sites``
    the synchronising calls by innermost span and the host operation that
    made them)."""
    window = [e for e in events if e.get("name") == trace.WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    spans = _Spans(events, w0, w1)
    table = {name: {"calls": 0, "seconds": 0.0, "self_seconds": 0.0,
                    "syncs": 0, "idle_s": 0.0} for name in spans.names}
    for name in spans.names:
        table[name]["calls"] += 1
    out = {"spans": table, "outside_s": 0.0, "outside_syncs": 0,
           "outside_idle_s": 0.0, "device_s": 0.0}

    launch_ts = {}
    for e in events:
        if e.get("cat") in trace.LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
    dev = [e for e in events if e.get("cat") in trace.DEVICE_CATS and "dur" in e
           and w0 <= float(e["ts"]) <= w1]
    for e in dev:
        dur = float(e["dur"]) * 1e-6
        out["device_s"] += dur
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        i = -1 if t is None else spans.innermost(t)
        if i < 0:
            out["outside_s"] += dur
            continue
        table[spans.names[i]]["self_seconds"] += dur
        for name in spans.chain(i):
            table[name]["seconds"] += dur

    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in events if e.get("cat") == "cpu_op" and "dur" in e)
    op_starts = [s for s, _, _ in ops]
    sites = {}
    for e in events:
        if (e.get("cat") in trace.LAUNCH_CATS and e.get("name") in SYNC_CALLS
                and w0 <= float(e["ts"]) <= w1):
            t = float(e["ts"])
            i = spans.innermost(t)
            if i < 0:
                out["outside_syncs"] += 1
            else:
                table[spans.names[i]]["syncs"] += 1
            # the outermost host operation that made the call
            j = bisect.bisect_right(op_starts, t) - 1
            op = "no operation"
            for s, end, name in ops[max(0, j - 64):j + 1]:
                if s <= t <= end:
                    op = name
                    break
            site = f"{spans.names[i] if i >= 0 else '(outside)'} / {op}"
            sites[site] = sites.get(site, 0) + 1
    out["sync_sites"] = sites

    if dev:
        starts = np.array([float(e["ts"]) for e in dev])
        ends = np.minimum(starts + np.array([float(e["dur"]) for e in dev]), w1)
        merged = trace._merge(starts, ends)
        edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
        for k in range(0, len(edges), 2):
            gap = float(edges[k + 1] - edges[k]) * 1e-6
            if gap <= 0:
                continue
            i = spans.innermost(edges[k])
            if i < 0:
                out["outside_idle_s"] += gap
            else:
                table[spans.names[i]]["idle_s"] += gap
    return out


def span_seconds(program: dict, name: str) -> tuple[float, int]:
    """(inclusive device seconds, calls) of program span ``name``; raises
    ``trace.RangeMissing`` where there is nothing to read."""
    got = program["spans"].get(name, {"calls": 0, "seconds": 0.0})
    if not got["calls"] or got["seconds"] <= 0:
        raise trace.RangeMissing(
            f"program span {name!r}: {got['calls']} calls, {got['seconds']} "
            "device seconds in the traced window")
    return got["seconds"], got["calls"]


def decode_bound_s(h, batch: int, iters: int) -> float:
    """A final-output decode: its f32 instructions (``nms_edge_ops``)
    against the LLRs in and the soft outputs out (f32 each)."""
    n = h.shape[1]
    return roofline.bound_s(8 * batch * n,
                            roofline.nms_edge_ops(h, batch, iters) / roofline.F32_INSTR)


def _syncs_per(program: dict, unit: str) -> float:
    _, calls = span_seconds(program, unit)
    return sum(s["syncs"] for s in program["spans"].values()) / calls


def capture_decode_roofline(ctx):
    if ctx.kind != "system" or ctx.trace is None:
        return None
    spent, calls = span_seconds(ctx.trace["program"], "capture.decode")
    w = ctx.work
    return 100.0 * calls * decode_bound_s(w["h"], w["cap_b"], w["iters"]) / spent


def k5_roofline(ctx):
    if ctx.kind != "system" or ctx.trace is None:
        return None
    spent, calls = span_seconds(ctx.trace["program"], "minima.k5")
    w = ctx.work
    return 100.0 * calls * roofline.k5_bound_s(
        w["cap"], w["m"], w["k"], w["teps"]) / spent


def host_syncs_per_round(ctx):
    if ctx.kind != "system" or ctx.trace is None:
        return None
    return _syncs_per(ctx.trace["program"], "round")


def host_syncs_per_step(ctx):
    if ctx.kind != "phase1" or ctx.trace is None:
        return None
    return _syncs_per(ctx.trace["program"], "mc.step")


def osd_rows_useful_pct(ctx):
    counters = (ctx.profile or {}).get("counters", {})
    if ctx.kind != "system" or not counters.get("osd.rows"):
        return None
    return 100.0 * counters["osd.failures"] / counters["osd.rows"]


# the per-layer metrics that would read the program's spans and counters
READINGS = {
    "capture_decode_roofline": capture_decode_roofline,
    "k5_roofline": k5_roofline,
    "host_syncs_per_round.system": host_syncs_per_round,
    "host_syncs_per_step.phase1": host_syncs_per_step,
    "osd_rows_useful_pct.system": osd_rows_useful_pct,
}


def span_table(program: dict, units: int) -> str:
    """The spans as lines: per unit, self and inclusive device ms, syncs and
    idle ms."""
    rows = [f"{'span':<16}{'calls/unit':>11}{'self ms':>10}{'incl ms':>10}"
            f"{'syncs':>8}{'idle ms':>9}"]
    for name, s in sorted(program["spans"].items(), key=lambda kv: -kv[1]["seconds"]):
        rows.append(f"{name:<16}{s['calls'] / units:>11.3f}"
                    f"{1e3 * s['self_seconds'] / units:>10.4f}"
                    f"{1e3 * s['seconds'] / units:>10.4f}"
                    f"{s['syncs'] / units:>8.3f}{1e3 * s['idle_s'] / units:>9.4f}")
    rows.append(f"{'(outside)':<16}{'':>11}{1e3 * program['outside_s'] / units:>10.4f}"
                f"{'':>10}{program['outside_syncs'] / units:>8.3f}"
                f"{1e3 * program['outside_idle_s'] / units:>9.4f}")
    return "\n".join(rows)


class RecordingTracer(trace.Tracer):
    """``trace.Tracer`` whose window records the port's spans and counters
    (with the profiler when traced) and whose summary adds the program."""

    last = None

    @contextlib.contextmanager
    def window(self):
        from short_ldpc_decoding_osd_tpu_torch.utils import profiling

        profiling.reset()
        with super().window(), profiling.recording():
            yield

    def summary(self) -> dict:
        size = os.path.getsize(self.path)
        with open(self.path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(self.path)
        out = trace.reduce_events(events) | {
            "trace_bytes": size, "program": reduce_program(events)}
        RecordingTracer.last = out
        return out


def alternating_drive(turns: int):
    """A ``kinds.drive`` for an untraced window of ``turns`` turns of four
    equal blocks, recording off, on, on, off; and the seconds a unit of
    each block, by recording state."""
    import time

    from gpubench import kinds
    from short_ldpc_decoding_osd_tpu_torch.utils import profiling

    per_unit = {"off": [], "on": []}

    def drive(unit, seconds, dev, tracer, t_start):
        out = {"setup_s": time.perf_counter() - t_start, "lead": None}
        first, total = 0, 0.0
        for _ in range(turns):
            for state in ("off", "on", "on", "off"):
                with (profiling.recording() if state == "on"
                      else contextlib.nullcontext()):
                    units, spent = kinds._loop(unit, first, seconds / (4 * turns),
                                               dev)
                per_unit[state].append(spent / units)
                first, total = first + units, total + spent
        profiling.reset()
        return out | {"units": first, "window_s": total, "ran": first}

    return drive, per_unit


def main(argv=None) -> int:
    import argparse
    import importlib
    import statistics
    import time

    t_start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=1)
    parser.add_argument("--cost", type=int, default=0, metavar="TURNS",
                        help="untraced: alternate recording off and on over "
                             "TURNS turns of the window")
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(root, "build", "gpubench-cache", sub)
    from gpubench import core
    from short_ldpc_decoding_osd_tpu_torch.utils import profiling

    seen = {}
    read_metrics = core.read_metrics

    def read_and_keep(specs, ctx):
        seen["ctx"] = ctx
        return read_metrics(specs, ctx)

    core.read_metrics = read_and_keep
    extra = {}
    if args.cost:
        if args.trace:
            parser.error("--cost runs untraced: pass --trace 0")
        kind = importlib.import_module(
            "gpubench.kinds." + core.find_cell(root, args.workload).traffic["kind"])
        kind.drive, per_unit = alternating_drive(args.cost)
    else:
        trace.Tracer = RecordingTracer
    line = core.run_cell(root, args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start)
    ctx = seen["ctx"]
    if args.cost:
        off, on = (statistics.median(per_unit[k]) for k in ("off", "on"))
        extra = {"per_unit_s": per_unit, "off_median_s": off, "on_median_s": on,
                 "cost": on / off - 1.0}
    elif args.trace:
        ctx.profile = profiling.snapshot()
        summary = RecordingTracer.last
        program = summary["program"]
        readings = {}
        for name, fn in READINGS.items():
            value = fn(ctx)
            if value is not None:
                readings[name] = value
        same = {}
        for span, rng in SAME_CALL:
            if span in program["spans"] and rng in summary["ranges"]:
                a, b = program["spans"][span]["seconds"], summary["ranges"][rng]
                same[span] = [a, b, (a - b) / b if b else None]
        rounds = program["spans"].get("round", {}).get("seconds")
        extra = {"readings": readings, "same_call": same,
                 "round_share": (rounds / program["device_s"]) if rounds else None,
                 "counters": ctx.profile["counters"], "units": ctx.units,
                 "program": program}
        print(span_table(program, ctx.units), file=sys.stderr, flush=True)
    print(json.dumps(line | {"spans": extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
