"""The reference's frozen copies against the port they were copied from,
at small sizes on the CPU, and the roofline arithmetic against the bounds
that PERF.md's kernel table pins."""

import os

import numpy as np
import pytest
import torch

from gpubench import core, roofline
from gpubench.reference import artifacts, codes, osd, sampling
from short_ldpc_decoding_osd_tpu_torch.channel.awgn import ChannelSpec, sample_batch
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.convert import load_run
from short_ldpc_decoding_osd_tpu_torch.ops import mc_hash, nms_edge
from short_ldpc_decoding_osd_tpu_torch.osd import segments

from conftest import ROOT

CODES = ("ccsds_128_64", "wimax_1056_880")
RUNS = {"ccsds_128_64": "runs/r4_pipeline",
        "wimax_1056_880": "runs/r5_multicode/wimax_1056_880"}


def _h(name):
    with np.load(os.path.join(ROOT, "short_ldpc_decoding_osd_tpu_torch", "data",
                              name + ".npz")) as blob:
        return blob["h"].astype(np.uint8)


@pytest.mark.parametrize("name", CODES)
def test_generator_and_edges_match_the_port(name):
    code = get_code(name)
    h = _h(name)
    assert np.array_equal(codes.generator(h), code.g)
    edge_col, var_edges = codes.edges(h)
    want_col, want_var = nms_edge.edge_layout(code.h)
    assert np.array_equal(edge_col, want_col) and np.array_equal(var_edges, want_var)


@pytest.mark.parametrize("name", CODES)
def test_tep_table_matches_the_port(name):
    cfg = {"run_dir": RUNS[name], "parity_file": f"short_ldpc_decoding_osd_tpu_torch/data/{name}.npz",
           "dia_model": "model_cnn"}
    run = artifacts.load_run(ROOT, cfg)
    k = get_code(name).k
    flat, valid, bounds = codes.tep_table(run["path"], k)
    blocks, _ = segments.build_tep_blocks(run["path"], k, 6)
    teps, mask, want_bounds = segments.pack_tep_chunks(blocks)
    assert np.array_equal(flat, teps.reshape(-1, k))
    assert np.array_equal(valid, mask.reshape(-1)) and tuple(bounds) == want_bounds


@pytest.mark.parametrize("name", CODES)
def test_artifacts_match_the_port(name):
    cfg = {"run_dir": RUNS[name], "parity_file": f"short_ldpc_decoding_osd_tpu_torch/data/{name}.npz",
           "dia_model": "model_cnn"}
    run = artifacts.load_run(ROOT, cfg)
    port = load_run(os.path.join(ROOT, RUNS[name]), "cpu")
    w = torch.nn.functional.softplus(port["nms_params"]["check"])[0]
    assert core.decoder("NMS-1").weights(run["nms"]) == (1.0, float(w), 1.0)
    taps, bias = osd.dia_filter(run["conv"], run["head_kernel"], run["head_bias"], 13)
    want_taps, want_bias = port["dia"].effective_filter()
    assert np.allclose(taps, want_taps.numpy(), rtol=1e-5, atol=1e-6)
    assert abs(bias - float(want_bias)) < 1e-5
    assert np.array_equal(run["w1"], port["fcn"]["w1"].numpy().astype(np.float64))


def test_awgn_round_matches_the_port():
    code = get_code("ccsds_128_64")
    g = torch.as_tensor(code.g, dtype=torch.float32)
    sigma = sampling.sigma_for_snr(3.0, code.rate)
    llr, words = sampling.awgn_round(2**31 + 7, 3, g, 512, sigma)
    gen = torch.Generator().manual_seed(sampling.round_seed(2**31 + 7, 3))
    want_llr, want_words = sample_batch(gen, ChannelSpec.awgn(3.0, code.rate), g, 512)
    assert torch.equal(llr, want_llr) and torch.equal(words, want_words)


@pytest.mark.parametrize("name", CODES)
def test_hash_frames_match_the_port(name):
    code = get_code(name)
    g = torch.as_tensor(code.g, dtype=torch.float32)
    fid = torch.arange(1000, 1300, dtype=torch.int64)
    seed = sampling.step_seed(2**31 + 99, 5)
    sigma = sampling.sigma_for_snr(4.0, code.rate)
    cw, llr = sampling.hash_frames(fid, seed, g, sigma)
    want_cw, want_llr = mc_hash.sample(fid, seed, g, float(np.float32(sigma)))
    assert torch.equal(cw, want_cw) and torch.equal(llr, want_llr)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0e-3, 1.0 + 2**-10])
    got = osd.tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2**-9, float(osd.tf32(x[3:4])[0]), 1.0 + 2**-10]
    assert abs(float(got[3]) + 3.0e-3) < 3.0e-3 * 2**-10


def test_bounds_of_the_kernel_table():
    """The bounds (ms) of PERF.md's kernel table at the main path's shapes."""
    ccsds = get_code("ccsds_128_64").h
    k1 = roofline.bound_s(4 * 262_144 * 128 * 2,
                          roofline.nms_edge_ops(ccsds, 262_144, 12) / roofline.F32_INSTR)
    assert round(k1 * 1e3, 4) == 0.4137
    assert round(roofline.ge_bound_s(32_768, 64, 128, 64, "perm") * 1e3, 4) == 0.0551
    assert round(roofline.k5_bound_s(32_768, 64, 64, 1_536) * 1e3, 4) == 0.2083
    # K3 at 2,097,152 frames, 702,310 of them unconverged at t1 = 4
    big, unconv = 2_097_152, 702_310
    k3 = roofline.compact_bound_s(ccsds, big * 4 + unconv * 8, big + unconv)
    assert round(k3 * 1e3, 4) == 1.8731
    assert round(roofline.k5_bound_s(1_024, 176, 880, 102_912) * 1e3, 4) == 16.4947
