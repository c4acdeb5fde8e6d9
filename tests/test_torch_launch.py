"""The port's launch tools against the JAX package's: the cost model's
formulas, its H100 terms, the FlopCounterMode calibration, and the dry-run
and roofline end to end.

- ``CellCost`` (flops, model_flops, hbm_bytes, coll_bytes and ``detail``)
  equal to the reference's for every arch x runnable shape x production
  mesh, at the microbatch count both packages pick: the formulas are a
  copy, the same float operations in the same order.
- ``terms`` are those fields over one H100 SXM5's data-sheet peaks.
- The per-layer flops calibration of tests/test_costmodel.py, redone
  against PyTorch's ``FlopCounterMode`` on ``meta`` tensors (plain
  attention, remat off, one microbatch): the depth delta between 4 and 2
  layers isolates one layer's forward and backward; the model's per-layer
  flops over the counted ones must lie in (0.7, 1.4), the reference
  test's bounds.
- On ``meta`` tensors the step loops run their like steps as one batch
  (xlstm's mLSTM chunks and sLSTM steps, MLA's kv blocks): the count,
  forward and backward, op by op, equals the loop's on CPU tensors.
- ``dryrun`` and ``roofline`` on one cell (yi-6b prefill_32k, both meshes,
  counted at full width on ``meta`` tensors).
"""
import dataclasses
import json
import os
import re
import types
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import costmodel as jcost
from repro.models import api as japi

from repro_torch.configs import (SHAPES, get_config, list_archs,
                                 reduce_for_smoke, runnable_shapes)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import costmodel, dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (build_model, default_micro_batches,
                                input_defs, loss_and_grads, make_prefill_step)
from repro_torch.models.params import abstract_tree, init_params

ROOT = Path(__file__).resolve().parents[1]
MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _fields(c):
    return (c.flops, c.model_flops, c.hbm_bytes, c.coll_bytes, c.detail)


@pytest.mark.parametrize("arch", list_archs())
def test_cell_cost_matches_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for mesh_shape in MESH_SHAPES:
        mesh = types.SimpleNamespace(shape=mesh_shape)
        for shape in runnable_shapes(cfg):
            jshape = J_SHAPES[shape.name]
            micro = default_micro_batches(cfg, shape, mesh)
            assert micro == japi.default_micro_batches(jcfg, jshape, mesh)
            kws = [{}]
            if shape.kind == "train":
                kws.append({"assume_ep": bool(cfg.num_experts)})
            else:
                kws.append({"wide_mlp": True})
            for kw in kws:
                got = costmodel.cost_cell(cfg, shape, mesh_shape, micro, **kw)
                want = jcost.cost_cell(jcfg, jshape, mesh_shape, micro, **kw)
                assert _fields(got) == _fields(want), (shape.name, mesh_shape, kw)


def test_terms_are_the_fields_over_h100_peaks():
    assert (costmodel.PEAK_FLOPS, costmodel.HBM_BW, costmodel.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    for arch in ("yi-6b", "dbrx-132b", "xlstm-125m"):
        cfg = get_config(arch)
        for shape in runnable_shapes(cfg):
            for mesh_shape, chips in ((MESH_SHAPES[0], 256),
                                      (MESH_SHAPES[1], 512), ({"data": 1}, 1)):
                c = costmodel.cost_cell(cfg, shape, mesh_shape)
                t = c.terms(chips)
                assert t["compute_s"] == c.flops / (chips * 989.4e12)
                assert t["memory_s"] == c.hbm_bytes / (chips * 3.35e12)
                assert t["collective_s"] == c.coll_bytes / (chips * 450e9)
                step = max(t["compute_s"], t["memory_s"], t["collective_s"])
                assert t["step_s"] == step
                assert t[t["dominant"] + "_s"] == step
                assert t["useful_ratio"] == c.model_flops / c.flops
                assert t["roofline_fraction"] == pytest.approx(
                    c.model_flops / (chips * 989.4e12) / step, rel=1e-12)


def test_no_tpu_figure_in_the_port():
    pat = re.compile(r"197e12|819e9|v5e")
    hits = [f"{p}:{i}" for p in (ROOT / "src" / "repro_torch").rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []


def _counted_train_flops(cfg, shape):
    model = build_model(cfg, device="meta")
    params = abstract_tree(model.param_defs())
    batch = abstract_tree(input_defs(cfg, shape))
    with FlopCounterMode(display=False) as fc:
        loss_and_grads(model, params, batch)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-8b"])
def test_per_layer_flops_calibration(arch):
    base = reduce_for_smoke(get_config(arch))
    shape = ShapeConfig("t", 64, 2, "train")
    mk = lambda n: dataclasses.replace(base, num_layers=n,
                                       attention_impl="torch",
                                       remat_policy="none")
    f2, f4 = _counted_train_flops(mk(2), shape), _counted_train_flops(mk(4), shape)
    counted_per_layer = (f4 - f2) / 2
    tokens = shape.global_batch * shape.seq_len
    ana_per_layer = (costmodel._fwd_flops_per_token(mk(4), shape.seq_len)
                     - costmodel._fwd_flops_per_token(mk(2), shape.seq_len)) \
        / 2 * tokens * 3.0
    ratio = ana_per_layer / counted_per_layer
    assert 0.7 < ratio < 1.4, f"{arch}: analytic/counted per layer = {ratio:.3f}"


# (arch, kind, seq): 4, 4 (padded) and 2 chunks of 64 for xlstm's reduced
# config (sLSTM at layer 3); 4 and 4 (short last) kv blocks of 32 for
# deepseek-v3's reduced MLA
LOOP_CASES = [("xlstm-125m", "train", 256), ("xlstm-125m", "prefill", 200),
              ("xlstm-125m", "train", 100), ("deepseek-v3-671b", "train", 128),
              ("deepseek-v3-671b", "prefill", 100)]


@pytest.mark.parametrize("arch,kind,seq", LOOP_CASES)
def test_meta_count_equals_the_loops(arch, kind, seq):
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              attention_impl="torch")
    shape = ShapeConfig("t", seq, 2, kind)
    counts = {}
    for device in ("meta", "cpu"):
        model = build_model(cfg, device=device)
        tree = (abstract_tree if device == "meta"
                else lambda defs: init_params(defs, 0, "cpu"))
        params, batch = tree(model.param_defs()), tree(input_defs(cfg, shape))
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            if kind == "train":
                loss_and_grads(model, params, batch)
            else:
                make_prefill_step(model)(params, batch)
        counts[device] = {str(k): v for k, v in
                          fc.get_flop_counts()["Global"].items()}
    assert counts["meta"] == counts["cpu"] and counts["cpu"]


def test_dryrun_and_roofline_end_to_end(tmp_path, capsys):
    out = tmp_path / "dry"
    dryrun.main(["--arch", "yi-6b", "--shape", "prefill_32k", "--mesh", "both",
                 "--out", str(out)])
    reports = sorted(out.glob("*.json"))
    assert [p.name for p in reports] == ["yi-6b_prefill_32k_pod16x16.json",
                                         "yi-6b_prefill_32k_pod2x16x16.json"]
    r = json.loads(reports[0].read_text())
    cfg, shape = get_config("yi-6b"), SHAPES["prefill_32k"]
    assert r["counted_attention_impl"] == "torch"
    assert r["chips"] == 256 and r["mesh_shape"] == {"data": 16, "model": 16}
    cost = costmodel.cost_cell(cfg, shape, r["mesh_shape"])
    assert r["cost_model"]["flops"] == cost.flops
    # the counted products: the cost model's projections, attention and
    # head, within the reference calibration's bounds
    assert 0.7 < r["counted_flops"] / cost.flops < 1.4
    assert r["counted_flops"] == sum(r["counted_flops_by_op"].values())
    assert not any(k.startswith("hlo") for k in r)
    capsys.readouterr()
    roofline.main(["--dir", str(out), "--out", str(tmp_path / "roof.json"),
                   "--mesh", "pod2x16x16"])
    table = capsys.readouterr().out.splitlines()
    rows = json.loads((tmp_path / "roof.json").read_text())
    assert len(rows) == 2 and len(table) == 3      # header, rule, 1 row
    row = next(x for x in rows if x["mesh"] == "pod16x16")
    assert row["counted_over_analytic"] == r["counted_flops"] / cost.flops
    assert row["fits_device_memory"] and row["dominant"] in (
        "compute", "memory", "collective")
    assert os.path.exists(tmp_path / "roof.json")


def test_dryrun_counts_on_meta_and_allocates_nothing():
    mesh = make_production_mesh(device="meta")
    fn, args, cfg, rules, micro = dryrun.build_cell("qwen3-8b", "decode_32k",
                                                    mesh)
    assert cfg.attention_impl == "torch" and cfg.embedding_impl == "mapsin"
    from repro_torch.common import tree_paths
    assert all(t.device.type == "meta" for _, t in tree_paths(args))
    flops, by_op = dryrun.count_flops(fn, args)
    assert flops > 0 and flops == sum(by_op.values())
