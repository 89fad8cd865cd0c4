"""The port's command line, ``sldpc-torch`` (port of the JAX package's
``sldpc``, ``short_ldpc_decoding_osd_tpu/cli/main.py``).

Subcommands:
  train-nms     stage 1+2: train an NMS variant
  eval-nms      stage 4+5: Monte-Carlo FER at SNR points
  train-dia     stage 3a: DIA refiner + decoding path
  train-stopper stage 3b: sliding-window stopper
  sweep         stages 1-7 end-to-end (two-phase FER curve)
  baseline      FS-OSD / PB-OSD / conventional OSD / miracle view
  bench         one-card throughput, ``bench.py``'s line: phase 1 at --batch
                and --snr, the two-phase system at 3.0 dB

Every subcommand takes ``--device`` (default ``cuda``, which raises when no
card is present).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

# every advertised choice resolves through models.canonical_dia_name
DIA_MODEL_CHOICES = ["model_cnn", "cnn", "model_rnn1", "rnn_one", "rnn1",
                     "model_rnn2", "rnn_two", "rnn2"]


def _add_common(p):
    p.add_argument("--code", default="ccsds_128_64")
    p.add_argument("--variant", default="NMS-1")
    p.add_argument("--iterations", type=int, default=12)
    p.add_argument("--run-dir", default="./runs/default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain PyTorch versions)")


def _add_dia_model(p):
    p.add_argument("--dia-model", default="model_cnn",
                   choices=DIA_MODEL_CHOICES)


def _add_osd_point(p):
    """Stage-6 operating point (reference defaults,
    ``DL_OSD_Testing_serial/globalmap.py:49-55``)."""
    p.add_argument("--threshold-sum", type=int, default=3,
                   help="max order-pattern weight on the decoding path "
                        "(~OSD order)")
    p.add_argument("--decoding-length", type=int, default=30,
                   help="max order patterns on the decoding path")
    p.add_argument("--window", type=int, default=5,
                   help="sliding stopper window width (block minima)")
    p.add_argument("--soft-margin", type=float, default=0.9,
                   help="stopper P[stop] threshold in (0, 1)")
    p.add_argument("--segments", type=int, default=6,
                   help="MRB reliability segments for order patterns")


def _osd_point_kwargs(args) -> dict:
    if not 0.0 < args.soft_margin < 1.0:
        raise SystemExit(f"--soft-margin must be in (0, 1), got {args.soft_margin}")
    if args.window < 1 or args.window > args.decoding_length:
        raise SystemExit(
            f"--window must be in [1, --decoding-length], got {args.window} "
            f"vs {args.decoding_length}")
    if args.threshold_sum < 0 or args.segments < 1:
        raise SystemExit("--threshold-sum must be >= 0 and --segments >= 1")
    return {
        "threshold_sum": args.threshold_sum,
        "decoding_length": args.decoding_length,
        "window": args.window,
        "soft_margin": args.soft_margin,
        "num_segments": args.segments,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sldpc-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train-nms", help="train the NMS decoder")
    _add_common(p)
    p.add_argument("--snr", type=float, default=2.7)
    p.add_argument("--snr-hi", type=float, default=None)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--batch", type=int, default=100)

    p = sub.add_parser("eval-nms", help="Monte-Carlo NMS FER at SNR points")
    _add_common(p)
    p.add_argument("--snrs", default="2.0:3.0:6")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--error-budget", type=int, default=40000)
    p.add_argument("--max-frames", type=int, default=10**8)
    p.add_argument("--channel", choices=["awgn", "rayleigh"], default="awgn",
                   help="rayleigh = block fading (reference stage-4 option, "
                        "Testing_data_gen_128/data_generating.py:21-38)")
    p.add_argument("--fade-duration", type=int, default=1,
                   help="fading blocks of 16 x this many bits (rayleigh "
                        "only)")

    for name, hlp in (
        ("train-dia", "stage 3a: DIA refiner + learned decoding path"),
        ("train-stopper", "stage 3b: sliding-window stopper (implies 3a)"),
    ):
        p = sub.add_parser(name, help=hlp)
        _add_common(p)
        p.add_argument("--training-snr", type=float, default=2.7)
        _add_dia_model(p)
        _add_osd_point(p)
        p.add_argument("--train-failures", type=int, default=20000)
        p.add_argument("--batch", type=int, default=4096)

    p = sub.add_parser("sweep", help="full two-phase pipeline + FER curve")
    _add_common(p)
    p.add_argument("--snrs", default="2.0:3.0:6")
    p.add_argument("--training-snr", type=float, default=2.7)
    _add_dia_model(p)
    _add_osd_point(p)
    p.add_argument("--osd-budget", type=int, default=500)
    p.add_argument("--nms-budget", type=int, default=40000)
    p.add_argument("--train-failures", type=int, default=20000)
    p.add_argument("--max-frames", type=int, default=10**8)
    p.add_argument("--frame-portions", default=None,
                   help="comma-separated per-SNR-point fractions of "
                        "--max-frames, low -> high SNR (reference "
                        "portion_dis, Testing_data_gen_128/Main_test.py:"
                        "90-106), e.g. 0.05,0.075,0.2,0.5,0.75,1.0")

    p = sub.add_parser("baseline", help="run an OSD baseline on NMS failures")
    _add_common(p)
    p.add_argument("--kind", choices=["fs", "pb", "conventional", "miracle"],
                   required=True)
    p.add_argument("--snrs", default="2.0:3.0:6")
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--d-min", type=int, default=14)
    p.add_argument("--tau-psc", type=int, default=30)
    p.add_argument("--failure-budget", type=int, default=100)
    p.add_argument("--batch", type=int, default=4096)

    p = sub.add_parser("bench", help="one-card phase-1 and two-phase "
                                     "throughput, one JSON line")
    _add_common(p)
    p.add_argument("--batch", type=int, default=16384,
                   help="phase-1 frames a step")
    p.add_argument("--snr", type=float, default=3.0,
                   help="phase 1's and the numpy stand-in's SNR; the "
                        "two-phase system stays at 3.0 dB")

    args = ap.parse_args(argv)
    return _dispatch(args)


def _parse_snrs(spec: str):
    lo, hi, num = spec.split(":")
    return np.linspace(float(lo), float(hi), int(num))


def _banner(args):
    """Decoder-selection banner (reference ``display_selection.py:9-14``)."""
    print(f"My pid: {os.getpid()}")
    if getattr(args, "variant", "") == "SPA":
        print("Using Sum-Product Algorithm")
    else:
        print("Using one of Min-Sum variants")


def _nms_params(run, args, code):
    """The run directory's NMS parameters, else the variant's initial ones."""
    from ..ops import nms as nms_ops
    from ..pipeline.recipe import host_params

    if run.has("nms_params.pkl"):
        return host_params(run.load_pickle("nms_params.pkl"))
    print("no trained params in run dir; using init factor 0.67")
    return nms_ops.init_params(args.variant, code.h)


def _dispatch(args):
    from .. import convert
    from .._device import resolve_device
    from ..codes import get_code
    from ..models import canonical_dia_name
    from ..pipeline.recipe import RecipeConfig, RunDir, run_recipe

    device = resolve_device(args.device)
    if args.cmd in ("train-nms", "eval-nms", "sweep"):
        _banner(args)

    if args.cmd == "train-nms":
        from ..train import NMSTrainConfig, train_nms

        code = get_code(args.code)
        cfg = NMSTrainConfig(
            variant=args.variant,
            num_iterations=args.iterations,
            snr_lo=args.snr,
            snr_hi=args.snr_hi if args.snr_hi is not None else args.snr,
            batch=args.batch,
            termination_step=args.steps,
            seed=args.seed,
        )
        run = RunDir(args.run_dir)
        params, summary = train_nms(
            code, cfg, ckpt_dir=run.path("ckpt_nms"),
            log_fn=lambda r: print(
                f"step {r['step']} loss {r['loss']:.2f} fer {r['fer']:.4f}"),
            device=device)
        run.save_pickle("nms_params.pkl", convert.nms_to_jax(params))
        print(json.dumps(summary["params"]))
        return 0

    if args.cmd == "eval-nms":
        from ..channel import ChannelSpec
        from ..mc.harness import run_nms_mc

        code = get_code(args.code)
        run = RunDir(args.run_dir)
        params = _nms_params(run, args, code)
        points = []
        for snr in _parse_snrs(args.snrs):
            spec = (
                ChannelSpec.rayleigh_spec(float(snr), code.rate,
                                          duration=args.fade_duration)
                if args.channel == "rayleigh"
                else None  # the harness builds the AWGN spec
            )
            stats, _ = run_nms_mc(
                code, params, args.variant, args.iterations, float(snr),
                batch=args.batch, error_budget=args.error_budget,
                max_frames=args.max_frames, seed=args.seed, spec=spec,
                device=device)
            lo, hi = stats.fer_confidence()
            point = {"snr_db": float(snr), **stats.to_dict(), "fer_ci": [lo, hi]}
            points.append(point)
            print(json.dumps(point))
        run.save_json("nms_fer.json", {"points": points})
        return 0

    if args.cmd == "sweep":
        cfg = RecipeConfig(
            code_name=args.code,
            variant=args.variant,
            num_iterations=args.iterations,
            training_snr=args.training_snr,
            dia_model=canonical_dia_name(args.dia_model),
            **_osd_point_kwargs(args),
            nms_error_budget=args.nms_budget,
            osd_failure_budget=args.osd_budget,
            train_failure_target=args.train_failures,
            max_frames_per_snr=args.max_frames,
            frame_portions=(
                tuple(float(x) for x in args.frame_portions.split(","))
                if args.frame_portions else ()),
            seed=args.seed,
        )
        curve = run_recipe(cfg, args.run_dir, _parse_snrs(args.snrs),
                           device=device)
        print(json.dumps(curve["points"][-1]))
        return 0

    if args.cmd in ("train-dia", "train-stopper"):
        from ..pipeline.recipe import (
            stage_harvest_failures,
            stage_train_dia_and_path,
            stage_train_stopper,
        )

        code = get_code(args.code)
        run = RunDir(args.run_dir)
        cfg = RecipeConfig(
            code_name=args.code,
            variant=args.variant,
            num_iterations=args.iterations,
            training_snr=args.training_snr,
            dia_model=canonical_dia_name(args.dia_model),
            **_osd_point_kwargs(args),
            train_failure_target=args.train_failures,
            eval_batch=args.batch,
            seed=args.seed,
        )
        nms_params = _nms_params(run, args, code)
        fb = stage_harvest_failures(cfg, run, nms_params, device=device)
        model, path = stage_train_dia_and_path(cfg, run, fb, device=device)
        out = {"decoding_path_len": len(path)}
        if args.cmd == "train-stopper":
            stage_train_stopper(cfg, run, model, fb, path, device=device)
            out["stopper"] = "stopper_params.pkl"
        print(json.dumps(out))
        return 0

    if args.cmd == "baseline":
        return _run_baseline(args, device)

    if args.cmd == "bench":
        from .. import system

        print(json.dumps(system.bench(args.batch, args.snr, device)))
        return 0
    raise SystemExit(f"unknown command {args.cmd}")


def _baseline_failures(args, code, params, run, snr, device):
    """One NMS failure capture per (run dir, SNR), shared across the four
    ``baseline --kind`` invocations, under JAX's cache key and file names
    (``baseline_failures_{snr:.2f}dB.{npz,json}``): a run directory written
    by either package serves the other."""
    from ..mc.harness import FailureBatch, run_nms_mc

    key = {
        "snr_db": round(float(snr), 4),
        "seed": args.seed,
        "batch": args.batch,
        "failure_budget": args.failure_budget,
        "variant": args.variant,
        "iterations": args.iterations,
        "code": code.name,
        # list-of-lists (not tuples): the key must survive a JSON round trip
        "params": [
            [k2, np.round(np.asarray(params[k2]), 7).tolist()]
            for k2 in sorted(params)
        ],
    }
    tag = f"baseline_failures_{float(snr):.2f}dB"
    if run.has(tag + ".json"):
        meta = run.load_json(tag + ".json")
        if meta.get("key") == key:
            with np.load(run.path(tag + ".npz")) as blob:
                fb = FailureBatch(blob["traj"], blob["labels"],
                                  int(blob["overflow"]))
            return meta["fer_nms"], fb
    stats, fb = run_nms_mc(
        code, params, args.variant, args.iterations, float(snr),
        batch=args.batch, error_budget=args.failure_budget * 40,
        max_frames=10**7, seed=args.seed, capture_failures=True,
        capture_limit=args.failure_budget * 4, device=device,
    )
    fer_nms = stats.detected_failures / max(stats.frames, 1)
    np.savez_compressed(
        run.path(tag + ".npz"),
        traj=fb.trajectories, labels=fb.labels, overflow=fb.overflow,
    )
    run.save_json(tag + ".json", {"key": key, "fer_nms": fer_nms,
                                  "stats": stats.to_dict()})
    return fer_nms, fb


def _osd_summary(snr, res) -> dict:
    succ = res["success"].cpu().numpy()
    return {
        "snr_db": float(snr),
        "success": int(succ.sum()),
        "fail": int((~succ).sum()),
        "fer_osd": float((~succ).mean()),
    }


def _mean(t) -> float:
    return float(t.cpu().numpy().mean())


def _run_baseline(args, device):
    """NMS failures -> one of the G-domain baselines, per SNR point; writes
    ``baseline_{kind}.json`` with JAX's field names."""
    from ..baselines import conventional, fs_osd, pb_osd
    from ..codes import get_code
    from ..pipeline.recipe import RunDir

    code = get_code(args.code)
    run = RunDir(args.run_dir)
    params = _nms_params(run, args, code)
    results = []
    for snr in _parse_snrs(args.snrs):
        fer_nms, fb = _baseline_failures(args, code, params, run, snr, device)
        traj = fb.trajectories
        if not len(traj):
            results.append({"snr_db": float(snr), "note": "no failures"})
            continue
        n_use = min(len(traj), args.failure_budget * 2)
        llr = torch.as_tensor(np.ascontiguousarray(traj[:n_use, 0]),
                              dtype=torch.float32, device=device)
        labels = torch.as_tensor(np.asarray(fb.labels[:n_use]), device=device)
        if args.kind == "miracle":
            counter = conventional.miracle_view(llr, labels, code.g, code.k,
                                                device=device)
            out = {
                "snr_db": float(snr),
                "hist": dict(sorted(counter.items())),
                "floor_order3": conventional.miracle_fer_floor(counter, 3),
            }
        elif args.kind == "conventional":
            res = conventional.conventional_osd(
                llr, labels, code.g, code.k, order_limit=args.order,
                device=device)
            out = _osd_summary(snr, res) | {"num_teps": int(res["num_teps"])}
        elif args.kind == "fs":
            res = fs_osd.fs_osd(
                llr, labels, code.g, code.k, order_limit=args.order,
                beta=args.beta, d_min=args.d_min, tau_psc=args.tau_psc,
                device=device)
            out = _osd_summary(snr, res) | {"avg_teps": _mean(res["num_teps"])}
        else:  # pb
            res = pb_osd.pb_osd(
                llr, labels, code.g, code.k, snr_db=float(snr),
                order_limit=args.order, device=device)
            out = _osd_summary(snr, res) | {
                "avg_teps": _mean(res["num_teps"]),
                "suc_evals": _mean(res["suc_evals"]),
                # reference "Maintained_list" metric (pb_testing.py:196-209)
                "maintained_list": _mean(res["maintained_list"]),
            }
        out["fer_nms"] = fer_nms
        if "fer_osd" in out:
            out["fer_total"] = out["fer_nms"] * out["fer_osd"]
        results.append(out)
        print(json.dumps(out))
    run.save_json(f"baseline_{args.kind}.json", {"points": results})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
