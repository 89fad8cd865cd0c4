"""K3's launch chain resuming its frames from saved messages (the plain
twins on the CPU) vs the literal rule and the JAX-decoder golden, on two
codes and four schedules (see ``torch_mc_common`` for the golden)."""

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import nms_edge
from torch_mc_common import ATOL, _golden, _params

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "qc_96_48"])
@pytest.mark.parametrize("schedule,block,snr_db", [
    (((4, 0.375),), 1024, 3.0),  # bench.py's schedule
    (nms_edge.DEFAULT_COMPACT_SCHEDULE, 512, 3.0),
    (((4, 0.5), (2, 0.25)), 512, 2.0),  # two stages
    (((2, 0.125),), 128, 1.5),  # a capacity that overflows
], ids=["bench", "default", "two_stage", "overflow"])
def test_resumed_chain_matches_literal_rule_and_golden(code_name, schedule,
                                                       block, snr_db):
    """The launch chain as the card runs it, each stage resuming its frames
    from the messages the previous one saved, on the plain twins: equal to
    the literal rule (every frame decoded from scratch) counter for
    counter, and to the JAX-decoder golden within the tolerance."""
    batch, T, seed = 1024, 12, 19
    mc = nms_edge.mc_setup(get_code(code_name), _params(), "NMS-1", snr_db,
                           seed, "cpu")
    rows, final = nms_edge.build_rows_schedule(schedule, block, T)
    chain = nms_edge._compact_chain(mc, batch, block, rows, final,
                                    nms_edge._mc_frames_plain,
                                    nms_edge._group_rank_plain)
    literal = nms_edge._compact_plain(mc, batch, block, rows, final)
    np.testing.assert_array_equal(chain.numpy(), literal.numpy())
    stages, spent = [], 0
    for iters, cap in rows:
        spent += iters
        stages.append((spent, cap))
    want, overflow = _golden(code_name, seed, batch, T, snr_db=snr_db,
                             stages=tuple(stages), block=block)
    np.testing.assert_allclose(chain.numpy(), list(want) + [overflow],
                               atol=ATOL)
    if schedule == ((2, 0.125),):
        assert int(chain[5]) > 0
