"""One rank of the port's two-process ``parallel/`` cases on the CPU.

    python tests/torch_parallel_worker.py <rank> <world> <port> <dir>

Joins a gloo group of ``world`` processes over ``tcp://127.0.0.1:<port>``
through ``init_multihost``, runs every case of
``tests/test_torch_multiprocess.py`` on the mesh, and writes what it got
to ``<dir>/rank<rank>.json``.  The cases' settings and the inputs of the
OSD cases come from ``<dir>/inputs.pkl`` (numpy only).  JAX is blocked from import, so the run
also shows that ``parallel/`` needs none of it.  Not collected by pytest
(no ``test_`` prefix).
"""

import sys

sys.modules["jax"] = None  # noqa: E402  (before anything can import it)

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from short_ldpc_decoding_osd_tpu_torch import convert  # noqa: E402
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec  # noqa: E402
from short_ldpc_decoding_osd_tpu_torch.codes import get_code  # noqa: E402
from short_ldpc_decoding_osd_tpu_torch.mc import harness  # noqa: E402
from short_ldpc_decoding_osd_tpu_torch.ops import nms  # noqa: E402
from short_ldpc_decoding_osd_tpu_torch.osd.segments import TepLayout  # noqa: E402
from short_ldpc_decoding_osd_tpu_torch.parallel import (  # noqa: E402
    device_seeds, init_multihost, make_mesh, sharded_dl_osd_step,
    sharded_dl_osd_step_from_llr, sharded_nms_train_step,
    sharded_seed_counters)

def run_cases(mesh, inputs: dict) -> dict:
    code = get_code("ccsds_128_64")
    p = nms.init_params("NMS-1")
    out = {"size": mesh.size, "rank": mesh.rank,
           "jax_blocked": sys.modules.get("jax", 0) is None}
    f = inputs["fused"]
    stats, _ = harness.run_nms_mc(code, p, "NMS-1", f["num_iterations"],
                                  f["snr_db"], batch=f["batch"],
                                  error_budget=f["error_budget"],
                                  seed=f["seed"], mesh=mesh)
    out["fused"] = dataclasses.asdict(stats)
    x = inputs["xla"]
    stats, _ = harness.run_nms_mc(code, p, "NMS-1", x["num_iterations"],
                                  x["snr_db"], batch=x["batch"],
                                  max_frames=x["max_frames"], seed=x["seed"],
                                  rung="xla", mesh=mesh)
    out["xla"] = dataclasses.asdict(stats)

    dia = convert.dia_module("model_cnn", code.n, inputs["t"] + 1,
                             convert.dia_state_from_jax(inputs["dia"], "cpu"))
    fcn, fcn_llr = ({k: torch.as_tensor(v) for k, v in inputs[key].items()}
                    for key in ("fcn", "fcn_llr"))
    layout = TepLayout.build(inputs["path"], code.k, 6, "cpu",
                             chunk=inputs["chunk"])
    step = sharded_dl_osd_step(dia, code.h, code.k, mesh, layout)
    c = step(torch.as_tensor(inputs["traj"]), torch.as_tensor(inputs["labels"]),
             fcn)
    out["osd"] = {"dtype": str(c.dtype), "counters": c.tolist()}
    # one row over two ranks: rank 1's part is empty
    c = step(torch.as_tensor(inputs["traj"][:1]),
             torch.as_tensor(inputs["labels"][:1]), fcn)
    out["osd_one_row"] = c.tolist()
    step = sharded_dl_osd_step_from_llr(dia, code, "NMS-1", inputs["t"], mesh,
                                        layout)
    c = step(nms.init_params("NMS-1"), torch.as_tensor(inputs["llr"]),
             torch.as_tensor(inputs["llr_labels"]), fcn_llr)
    out["osd_from_llr"] = {"dtype": str(c.dtype), "counters": c.tolist()}

    t = inputs["train"]
    for variant in ("NMS-1", "ENMS"):
        spec = ChannelSpec.awgn(t["snr_db"], code.rate)
        make_optimizer, train = sharded_nms_train_step(
            code, variant, t["num_iterations"], spec, t["per_device_batch"],
            mesh)
        params = {k: v.requires_grad_() for k, v in
                  nms.init_params(variant).items()}
        optimizer = make_optimizer(params)
        generator = torch.Generator()
        losses, trail = [], []
        for i in range(t["steps"]):
            generator.manual_seed(t["seed"] + i)
            losses.append(float(train(params, optimizer, generator)))
            trail.append({k: v.detach().tolist() for k, v in params.items()})
        out[f"train_{variant}"] = {"losses": losses, "params": trail}

    s = inputs["seeds"]
    fn = sharded_seed_counters(mesh, lambda _, seed: torch.tensor(
        [seed % 7, 1, seed], dtype=torch.int64))
    c = fn(None, device_seeds(s["base_seed"], s["idx"], mesh.size))
    out["seed_counters"] = {"dtype": str(c.dtype), "counters": c.tolist()}
    return out


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        out = run_cases(make_mesh(world, device="cpu"), inputs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    main()
