"""NMS training of the port (``train/``, ``utils/checkpoint.py``) vs the JAX
package (CPU).

Tolerances: the optimizer against optax on identical gradients 1e-6 abs and
1e-5 rel per step (torch's Adam divides by the bias corrections in another
order than optax; both in f32); loss gradients against JAX 1e-4 abs and rel
(the dense decoders sum in different orders), NMS-r and the extended H
relative to the gradient's largest entry (their magnitudes explode with
untrained weights or degree-10 rows).  A resumed run equals the
uninterrupted one exactly: the same frames, the same arithmetic on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.train.optim import staircase_adam
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge_padded
from short_ldpc_decoding_osd_tpu_torch.train import (
    NMSTrainConfig, StaircaseAdam, clip_each_by_norm_, nms_train, train_nms)
from short_ldpc_decoding_osd_tpu_torch.utils import checkpoint

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def test_staircase_adam_matches_optax():
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(0, 1, (3,)).astype(np.float32),
            "b": rng.normal(0, 1, (2, 2)).astype(np.float32)}
    # some gradients far above the clip norm, some below
    grads = [{k: (rng.normal(0, s, v.shape)).astype(np.float32)
              for k, v in init.items()} for s in (0.1, 10.0, 1.0, 30.0, 0.01,
                                                  3.0, 8.0, 0.5)]
    tx = staircase_adam(0.01, 3, 0.5, 5.0)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt = StaircaseAdam(tp.values(), 0.01, 3, 0.5, 5.0)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for k, v in tp.items():
            v.grad = torch.tensor(g[k])
        opt.step()
        for k in init:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)
    assert opt.adam.param_groups[0]["lr"] == pytest.approx(0.01 * 0.5 ** 2)


def test_clip_each_by_norm():
    big, small = torch.full((4,), 10.0), torch.tensor([0.3, 0.4])
    clip_each_by_norm_([big, small], 5.0)
    assert float(big.norm()) == pytest.approx(5.0)
    np.testing.assert_array_equal(small.numpy(), np.float32([0.3, 0.4]))


@pytest.mark.parametrize("name,variant", [
    ("ccsds_128_64", "NMS-1"), ("ccsds_128_64", "NMS-3"),
    ("ccsds_128_64", "NMS-r"), ("qc_96_48", "ENMS")])
def test_loss_gradients_match_jax(name, variant):
    jcode = jax_get_code(name)
    h = np.asarray(jcode.extended().h if variant == "ENMS" else jcode.h)
    rng = np.random.default_rng(1)
    llr = rng.normal(0.9, 1.0, (8, jcode.n)).astype(np.float32)
    words = rng.integers(0, 2, (8, jcode.n)).astype(np.int32)
    edge_cols = nms.edge_columns(h) if variant == "NMS-r" else None
    jp = jnms.init_params(variant, h)

    def jloss(p):
        outs = jnms.decode(p, jnp.asarray(h, jnp.float32), jnp.asarray(llr), 5,
                           variant, None if edge_cols is None else jnp.asarray(edge_cols))
        return jnms.multi_iteration_loss(outs, jnp.asarray(words))

    jval, jgrad = jax.value_and_grad(jloss)(jp)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jp.items()}
    loss = nms.multi_iteration_loss(
        nms.decode(tp, h, torch.as_tensor(llr), 5, variant, edge_cols),
        torch.as_tensor(words))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-4)
    scaled = variant in ("NMS-r", "ENMS")
    for k in tp:
        got, want = tp[k].grad.numpy(), np.asarray(jgrad[k])
        if scaled:
            assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _cfg(**kw):
    return NMSTrainConfig(**{**dict(num_iterations=4, batch=16, termination_step=6,
                                    print_interval=2, decay_steps=2), **kw})


@pytest.mark.parametrize("variant,accum", [("NMS-1", 1), ("NMS-r", 2)])
def test_resume_reproduces_uninterrupted(tmp_path, variant, accum):
    code = get_code("ccsds_128_64")
    records = []
    whole, summary = train_nms(code, _cfg(variant=variant, grad_accumulation=accum),
                               ckpt_dir=str(tmp_path / "a"),
                               log_fn=records.append, device="cpu")
    assert [r["step"] for r in records] == [2, 4, 6]
    assert summary["steps"] == 6 and len(summary["history"]["loss"]) == 3
    part, _ = train_nms(code, _cfg(variant=variant, grad_accumulation=accum,
                                   termination_step=2),
                        ckpt_dir=str(tmp_path / "b"), device="cpu")
    assert checkpoint.list_steps(str(tmp_path / "b")) == [1]
    resumed_records = []
    resumed, _ = train_nms(code, _cfg(variant=variant, grad_accumulation=accum),
                           ckpt_dir=str(tmp_path / "b"),
                           log_fn=resumed_records.append, device="cpu")
    assert [r["step"] for r in resumed_records] == [4, 6]
    for k in whole:
        assert torch.equal(resumed[k].detach(), whole[k].detach())
    assert resumed_records[-1]["loss"] == records[-1]["loss"]
    if variant == "NMS-r":
        assert all(float(whole[k].detach().min()) >= 0 for k in ("nn_w1", "nn_w2"))


def test_ring_repeats_batches_and_ring_loss():
    """Batch i of every epoch is the same frames; ring_loss evaluates a
    parameter set on them without an update."""
    code = get_code("code1_64_32")
    cfg = _cfg(num_batches=3)
    _, _, ring_batch = nms_train._setup(code, cfg, torch.device("cpu"))
    a, b = ring_batch(1, 0), ring_batch(4, 0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(ring_batch(2, 0)[0], a[0])
    p = nms.init_params("NMS-1")
    assert nms_train.ring_loss(code, cfg, p, [1], device="cpu") == \
        nms_train.ring_loss(code, cfg, p, [4], device="cpu")


@pytest.mark.parametrize("name,variant,device,want", [
    ("ccsds_128_64", "NMS-r", "cpu", False),
    ("wimax_1056_880", "NMS-1", "cpu", False),
    ("ccsds_128_64", "NMS-r", "cuda", True),
    ("wimax_1056_880", "NMS-1", "cuda", True),
    ("wimaxlike_384_192", "NMS-3", "cuda", True),
    ("ccsds_128_64", "NMS-1", "cuda", False),
    ("qc_96_48", "NMS-r", "cuda", False),
])
def test_train_select(name, variant, device, want):
    """On the CPU the trainer takes the dense decoder, as JAX off the TPU;
    on CUDA NMS-r and the codes above the dense rung's envelope take the
    padded edge layout (the rule reads the device's type, no card needed)."""
    assert nms_edge_padded.train_select(get_code(name).h, variant, device) is want


def test_checkpoint_rotation_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert checkpoint.load(d) is None and checkpoint.list_steps(d) == []
    for step in range(8):
        checkpoint.save(d, step, {"params": {"w": np.full(2, step, np.float32)},
                                  "state": {"t": torch.tensor([step])}},
                        extra={"variant": "NMS-1"})
    assert checkpoint.list_steps(d) == [3, 4, 5, 6, 7]
    step, tree, extra = checkpoint.load(d)
    assert step == 7 and extra == {"variant": "NMS-1"}
    np.testing.assert_array_equal(tree["params"]["w"], [7, 7])
    assert torch.equal(tree["state"]["t"], torch.tensor([7]))
    assert checkpoint.load(d, 4)[0] == 4
    checkpoint.save(d, 9, {}, keep=2)
    assert checkpoint.list_steps(d) == [7, 9]


def test_train_nms_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_nms(get_code("ccsds_128_64"), _cfg())
