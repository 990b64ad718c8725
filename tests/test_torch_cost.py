"""The port's cost account (``launch/cost.py``), its roofline half of
``launch/analysis.py`` and the dry run (``launch/dryrun.py``) against the
JAX package's, on the CPU.

- ``model_flops`` gives the reference's numbers for every config and
  shape, exactly;
- the account's dot FLOPs of a reduced forward equal the reference's
  while-trip-aware HLO count (``repro.launch.hlo_cost.HloCost``) of the
  same forward jitted on the CPU, at S of one attention block (where the
  plain flash loop and the reference's compute the same one block pair);
- the collective conventions on a hand-counted all-gather, and the
  roofline's arithmetic;
- the dry run's cells on a fake 2x4 mesh at reduced size: a train, a
  prefill and a decode step, with finite terms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.launch import analysis as ref_analysis
from repro.launch import hlo_cost as ref_hlo_cost
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.models import layers as ref_L
from repro.models import transformer as ref_T
from repro_torch.configs import base as configs
from repro_torch.launch import analysis, cost, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@pytest.mark.parametrize("arch", ref_configs.all_names())
def test_model_flops_match_reference(arch):
    for name, shape in SHAPES.items():
        assert analysis.model_flops(configs.get(arch), shape) == (
            ref_analysis.model_flops(ref_configs.get(arch), REF_SHAPES[name]))


@pytest.mark.parametrize("arch", ["qwen3-14b", "phi3.5-moe-42b-a6.6b"])
def test_dot_flops_match_hlo_cost(arch):
    """One forward (``forward_hidden``) at B=2, S=512: the account's dot
    FLOPs against ``HloCost`` of the reference's jitted forward. XLA
    keeps every product of this forward, so the counts are equal."""
    cfg_r = ref_configs.get(arch).reduced()
    cfg = configs.get(arch).reduced()
    params_r = ref_T.init_params(jax.random.PRNGKey(0), cfg_r, ref_L.FP32)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 512),
                                               dtype=np.int32)
    fwd = jax.jit(lambda p, t: ref_T.forward_hidden(p, t, cfg_r,
                                                    ref_L.FP32))
    hlo = fwd.lower(params_r, jnp.asarray(tokens)).compile().as_text()
    want = ref_hlo_cost.HloCost(hlo).total()["flops"]
    params = convert.from_reference(jax.tree.map(np.asarray, params_r),
                                    device="cpu")
    with cost.CostMode() as acct:
        T.forward_hidden(params, torch.from_numpy(tokens), cfg, L.FP32)
    got = acct.total()["flops"]
    assert got == pytest.approx(want, rel=1e-6)


def test_all_gather_of_a_sharded_weight_is_hand_counted():
    """A (64, 32) float32 weight sharded on both dims of a fake 2x4 mesh
    (local (32, 8), 1024 bytes) gathered whole: two all-gathers, over
    model (g=4) and data (g=2) in either order, 7168 ring bytes a device
    (3072 + 4096, or 1024 + 6144)."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed import partition
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_host_mesh(2, 4)
        w = partition.zeros((64, 32), partition.P("data", "model"), mesh,
                            torch.float32, "meta")
        assert tuple(w.to_local().shape) == (32, 8)
        with cost.CostMode() as acct:
            w.redistribute(mesh, (Replicate(), Replicate()))
    tot = acct.total()
    assert tot["collective_counts"]["all-gather"] == 2
    assert tot["collective_per_op"]["all-gather"] == 7168
    assert tot["collective_bytes"] == 7168


def test_collective_bytes_conventions():
    rec = [("all-gather", 800, 4), ("all-reduce", 800, 4),
           ("reduce-scatter", 200, 4), ("all-to-all", 800, 8),
           ("collective-permute", 100, 2)]
    out = analysis.collective_bytes(rec)
    assert out["per_op"] == {"all-gather": 600, "all-reduce": 1200,
                             "reduce-scatter": 600, "all-to-all": 700,
                             "collective-permute": 100}
    assert out["total_bytes"] == 3200
    assert all(n == 1 for n in out["counts"].values())


def test_roofline_arithmetic():
    acct = {"flops": 989e12, "flops_elementwise": 1.0, "bytes": 6.7e12,
            "collective_bytes": 45e9,
            "collective_per_op": {"all-gather": 45e9}}
    r = analysis.roofline(acct, 256, model_flops_per_device=494.5e12)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(2.0)
    assert r["collective_s"] == pytest.approx(0.1)
    assert r["dominant"] == "memory"
    assert r["roofline_fraction"] == pytest.approx(0.5)
    assert r["useful_flops_ratio"] == pytest.approx(0.5)
    assert analysis.memory_report({"argument_bytes": 10,
                                   "peak_bytes": 25}) == {
        "argument_size_in_bytes": 10, "temp_size_in_bytes": 15,
        "peak_bytes_per_device_est": 25}


def test_memory_mode_counts_live_storages():
    w = torch.zeros(100)
    with cost.MemoryMode() as mem:
        mem.hold({"w": w})
        for _ in range(3):
            x = torch.zeros(1000, device="meta")
            y = x + 1
            del x, y
    rep = mem.report()
    assert rep["argument_bytes"] == 400
    assert rep["peak_bytes"] == 400 + 8000
    assert rep["live_bytes"] == 400


CELLS = {"train": ShapeSpec("train_4k", 128, 8, "train"),
         "prefill": ShapeSpec("prefill_32k", 128, 8, "prefill"),
         "decode": ShapeSpec("decode_32k", 128, 8, "decode")}


@pytest.mark.parametrize("kind", list(CELLS))
def test_dryrun_cells_on_a_fake_host_mesh(kind):
    cfg = configs.get("qwen3-14b").reduced()
    with mesh_lib.fake_world(8):
        res = dryrun.lower_cell(cfg, CELLS[kind], mesh_lib.make_host_mesh(2, 4))
    r = res["roofline"]
    assert res["n_devices"] == 8 and res["mesh"] == "2x4"
    for k in ("compute_s", "memory_s", "collective_s"):
        assert math.isfinite(r[k]) and r[k] >= 0
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    mem = res["memory"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["peak_bytes_per_device_est"]
    if kind == "train":  # the FSDP gathers and gradient reductions
        assert r["collective_per_op"]["all-gather"] > 0
        assert r["collective_per_op"]["reduce-scatter"] > 0


def test_run_cell_skips_what_applicable_skips(tmp_path):
    res = dryrun.run_cell("qwen3-14b", "long_500k", False, str(tmp_path))
    assert res == {"arch": "qwen3-14b", "shape": "long_500k",
                   "mesh": "16x16", "skipped": "SKIP(full-attn)"}
    assert (tmp_path / "qwen3-14b__long_500k__16x16.json").exists()


def test_mesh_needs_the_world_it_names():
    with mesh_lib.fake_world(4):
        with pytest.raises(ValueError, match="needs a process group of 8"):
            mesh_lib.make_host_mesh(2, 4)
    with pytest.raises(ValueError, match="the default group has none"):
        mesh_lib.make_host_mesh(1, 1)
