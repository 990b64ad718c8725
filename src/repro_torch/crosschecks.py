"""Independent reconstruction of a WavePlan through the two DU kernels.

The port of ``frontier_crosschecks`` in the JAX package's
``benchmarks/bench_pallas.py``. For the monotonic producer/consumer
shapes of Table 1 it rebuilds, from the plan's own request streams:

  * the consumer waves of RAWloop, WARloop and WAWloop, through the
    hazard frontier kernel and ``wave_partition`` — they must equal the
    plan's ``req_wave``;
  * tanh+spmv's guarded forwarding (the §6-guarded producer ``st_v``
    into the SpMV value gather ``ld_vv``), through the forwarding kernel
    with valid bits — it must give the plan's ``ld_vv`` values bit for
    bit (values move as float64 words; the reference forwards them as
    float32 and compares within a tolerance), with at least one hit.

Programs whose producer streams are not globally monotonic (bnn's
per-row-sorted scatter, the CSR kernels) have no check and return an
empty list.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.du_hazard.ops import hazard_frontier, wave_partition
from repro_torch.kernels.fused_stream.ops import fused_stream, min_lookback

# (producer op, consumer op, hazard side): "right" counts the
# equal-address producer — the WAR store *waits for* the load of its own
# address, so all three directions merge side="right"
WAVE_PAIRS = {
    "RAWloop": ("st_a", "ld_a", "right"),
    "WARloop": ("ld_a", "st_a", "right"),
    "WAWloop": ("st_0", "st_1", "right"),
}
FORWARD_PROGRAM = "tanh+spmv"


def _op_stream(plan, op_id):
    """(addr, valid, value, wave) of one op, in program order."""
    rows = np.nonzero(plan.req_op == plan.op_ids.index(op_id))[0]
    return (plan.req_addr[rows], plan.req_valid[rows],
            plan.req_value[rows], plan.req_wave[rows])


def frontier_crosschecks(name, plan, arrays, *, device="cuda"):
    """Run the checks of program ``name`` on ``plan`` (built from
    ``arrays``) through the kernels on ``device`` (``"cuda"`` by
    default; ``"cpu"`` runs their plain versions, for tests). Returns
    the names of the checks performed; raises ``AssertionError`` on a
    mismatch."""
    dev = resolve_device(device, "frontier_crosschecks")
    done = []
    if name in WAVE_PAIRS:
        src_id, dst_id, side = WAVE_PAIRS[name]
        src_addr, _, _, src_wave = _op_stream(plan, src_id)
        dst_addr, _, _, dst_wave = _op_stream(plan, dst_id)
        f = hazard_frontier(
            torch.as_tensor(src_addr, device=dev),
            torch.as_tensor(dst_addr, device=dev), side=side,
        )
        got = wave_partition(f, torch.as_tensor(src_wave, device=dev))
        np.testing.assert_array_equal(
            got.cpu().numpy(), dst_wave,
            err_msg=f"{name}: kernel frontier waves != WavePlan ({dst_id})",
        )
        done.append(f"wave_partition[{side}]({src_id}->{dst_id})")
    if name == FORWARD_PROGRAM:
        src_addr, src_valid, src_value, _ = _op_stream(plan, "st_v")
        dst_addr, _, dst_value, _ = _op_stream(plan, "ld_vv")
        lb = min_lookback(src_addr)
        src = torch.as_tensor(src_addr, device=dev)
        dst = torch.as_tensor(dst_addr, device=dev)
        vals, hits = fused_stream(
            src,
            torch.as_tensor(np.where(src_valid, src_value, 0.0), device=dev),
            hazard_frontier(src, dst), dst,
            torch.as_tensor(np.asarray(arrays["v"], dtype=np.float64),
                            device=dev),
            torch.as_tensor(src_valid.astype(np.int32), device=dev),
            lookback=lb,
        )
        np.testing.assert_array_equal(
            vals.cpu().numpy().view(np.int64),
            np.asarray(dst_value, dtype=np.float64).view(np.int64),
            err_msg=f"{name}: guarded forwarding != plan ld_vv (bits)",
        )
        assert bool(hits.any()), f"{name}: no forwards — shape degenerate"
        done.append(f"fused_stream[valid,lb={lb}](st_v->ld_vv)")
    return done
