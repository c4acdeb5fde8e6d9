"""The port's sharding slice against the JAX package's: the logical-axis
rules, the sharded def-tree helpers, the vocab-sharded MAPSIN embedding,
the elastic checkpoint restore and training on a mesh.

- ``Rules.pspec`` and ``sharded_bytes_per_device`` are compared for every
  ParamDef of every ``list_archs()`` config at full width (parameters,
  optimizer state, decode caches and the inputs of each runnable shape)
  under 1x1, 2x4, 16x16 and 2x16x16. The reference's ``Rules`` reads only
  ``mesh.axis_names`` and ``mesh.shape``, so it takes a stand-in mesh.
  Specs and byte counts must be equal.
- ``mapsin_embed`` over ``LocalMesh(8, "cpu", axis="model")`` (and a
  ``Mesh`` whose model axis has 8 shards) against the reference's
  ``shard_map`` over 8 host devices, run once in one module-scoped
  subprocess (the device-count flag must never reach this process): equal
  bit for bit, ids outside the vocabulary included (a zero row in both);
  its three dense fallbacks too. The table's float32 gradient within 1e-6
  of the reference's largest (scatter-adds of repeated ids in another
  order), and equal bit for bit to the dense gather's.
- The elastic round trip save -> load(shardings) -> save -> load is exact.
- One ``make_train_step`` step and a one-step ``Trainer.run`` of qwen3-8b
  at ``reduce_for_smoke`` (float32, ``embedding_impl="mapsin"``) on a
  2x4 mesh against the reference's single-device step, within
  tests/test_torch_train.py's bounds; three ``Trainer`` steps on the mesh
  equal to three without it, bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common import tree_paths as j_tree_paths
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import api as japi
from repro.models import build_model as j_build_model
from repro.models.params import init_tree
from repro.models.params import sharded_bytes_per_device as j_sharded_bytes
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro.optim import opt_state_defs as j_opt_state_defs
from repro.runtime import Trainer as JTrainer
from repro.sharding import rules as jrules

from repro_torch.checkpoint import load, save
from repro_torch.common import dtype_of, tree_paths
from repro_torch.configs import (SHAPES, get_config, list_archs,
                                 reduce_for_smoke, runnable_shapes)
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import LocalMesh
from repro_torch.core import collectives
from repro_torch.launch.mesh import Mesh, make_mesh_for, make_production_mesh
from repro_torch.models import (build_model, default_micro_batches, embedding,
                                input_defs, make_train_step)
from repro_torch.models.params import (abstract_tree, params_from_numpy,
                                       pspec_tree, sharded_bytes_per_device,
                                       sharding_tree)
from repro_torch.optim import OptConfig, init_opt_state, opt_state_defs
from repro_torch.runtime import Trainer
from repro_torch.sharding import (NamedSharding, PartitionSpec, ShardedTensor,
                                  choose_kv_mode, make_rules, single_device_mesh)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
B, S = 2, 32
OPT = dict(learning_rate=3e-4, warmup_steps=10, decay_steps=110)


def _stand_in(name):
    axes, sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


def _key(path):
    return "/".join(str(p) for p in path)


# ---------------------------------------------------------------------------
# rules: every def tree of every arch, four meshes
# ---------------------------------------------------------------------------


def _def_trees(cfg, shape, model, micro, optim_defs, inputs):
    trees = {"params": model.param_defs(),
             "inputs": inputs(cfg, shape, micro)}
    if shape.kind == "train":
        trees["opt"] = optim_defs(trees["params"])
    if shape.kind == "decode":
        trees["cache"] = model.cache_defs(shape.global_batch, shape.seq_len)
    return trees


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_pspecs_and_bytes_match_reference(arch, mesh_name):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    axes, sizes = MESHES[mesh_name]
    mesh, jmesh = Mesh(axes, sizes), _stand_in(mesh_name)
    model, jmodel = build_model(cfg, device="meta"), j_build_model(jcfg)
    for shape in runnable_shapes(cfg):
        jshape = J_SHAPES[shape.name]
        micro = default_micro_batches(cfg, shape, mesh)
        assert micro == japi.default_micro_batches(jcfg, jshape, jmesh)
        rules = make_rules(mesh, cfg, shape)
        jr = jrules.make_rules(jmesh, jcfg, jshape)
        mine = _def_trees(cfg, shape, model, micro,
                          lambda d: opt_state_defs(d, OptConfig()), input_defs)
        theirs = _def_trees(jcfg, jshape, jmodel, micro,
                            lambda d: j_opt_state_defs(d, JOptConfig()),
                            japi.input_defs)
        assert sorted(mine) == sorted(theirs)
        for name in mine:
            got = {_key(p): tuple(rules.pspec(*d.axes))
                   for p, d in tree_paths(mine[name])}
            want = {_key(p): tuple(jr.pspec(*d.axes))
                    for p, d in j_tree_paths(theirs[name])}
            assert got == want, (shape.name, name)
            specs = pspec_tree(mine[name], rules)
            for p, d in tree_paths(mine[name]):
                leaf = specs
                for k in p:
                    leaf = leaf[k] if isinstance(leaf, dict) else leaf[int(k)]
                assert isinstance(leaf, PartitionSpec)
                assert tuple(leaf) == got[_key(p)]
            assert sharded_bytes_per_device(mine[name], rules) == \
                j_sharded_bytes(theirs[name], jr), (shape.name, name)


@pytest.mark.parametrize("mesh_name", ["2x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("kv", [1, 2, 4, 8, 16, 32])
def test_choose_kv_mode_matches_reference(kv, mesh_name):
    axes, sizes = MESHES[mesh_name]
    assert choose_kv_mode(kv, Mesh(axes, sizes)) == \
        jrules.choose_kv_mode(kv, _stand_in(mesh_name))
    data_only = types.SimpleNamespace(axis_names=("data",), shape={"data": 8})
    assert choose_kv_mode(kv, Mesh(("data",), (8,))) == \
        jrules.choose_kv_mode(kv, data_only) == "kv_heads"


OVERRIDES = [{}, {"dp_heavy": True}, {"seq_shard": True},
             {"serve": True, "wide_mlp_serve": True}, {"fsdp": False},
             {"fsdp_pod": True}, {"shard_batch": False},
             {"kv_mode": "head_dim"}, {"dp_heavy": True, "shard_batch": False}]


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b", "yi-6b"])
@pytest.mark.parametrize("i", range(len(OVERRIDES)))
def test_make_rules_overrides_match_reference(arch, i):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for mesh_name in ("2x4", "2x16x16"):
        axes, sizes = MESHES[mesh_name]
        for shape in (None, "train_4k", "long_500k"):
            r = make_rules(Mesh(axes, sizes), cfg,
                           SHAPES[shape] if shape else None, **OVERRIDES[i])
            jr = jrules.make_rules(_stand_in(mesh_name), jcfg,
                                   J_SHAPES[shape] if shape else None,
                                   **OVERRIDES[i])
            fields = [f.name for f in dataclasses.fields(r) if f.name != "mesh"]
            assert {f: getattr(r, f) for f in fields} == \
                {f: getattr(jr, f) for f in fields}
            assert r._map == jr._map


def test_meshes_and_abstract_trees():
    prod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (prod.axis_names, prod.shape, prod.size, prod.device) == \
        (("data", "model"), {"data": 16, "model": 16}, 256, None)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.shape.get("pod", 1) == 2 and prod.shape.get("pod", 1) == 1
    with pytest.raises(ValueError, match="abstract"):
        prod.axis_mesh("model")
    m = make_mesh_for(8, model_par=4, device="cpu")
    assert m.shape == {"data": 2, "model": 4}
    sub = m.axis_mesh("model")
    assert isinstance(sub, LocalMesh) and sub.shape == {"model": 4}
    assert make_mesh_for(8, device="cpu").shape == {"data": 8}
    with pytest.raises(ValueError):
        make_mesh_for(8, model_par=3, device="cpu")
    assert single_device_mesh("cpu").shape == {"data": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            single_device_mesh()
    cfg = get_config("qwen3-8b")
    rules = make_rules(prod, cfg)
    tree = abstract_tree(build_model(cfg, device="meta").param_defs(), rules)
    for p, t in tree_paths(tree):
        assert t.device.type == "meta"
        assert isinstance(t.sharding, NamedSharding)
    shard = sharding_tree({"e": build_model(cfg, device="meta").param_defs()["embed"]},
                          rules)["e"]
    assert shard.shard_shape(tree["embed"].shape) == (151936 // 16, 4096 // 16)


@pytest.mark.parametrize("shape,spec", [
    ((10, 7), ("model", None)),            # 10 rows over 4: padded blocks
    ((8, 6), (("data", "model"), None)),   # one dim over both axes
    ((5, 9, 3), (None, "data", "model")),  # 3 over 4: an empty last block
    ((6,), ()),                            # replicated everywhere
])
def test_named_sharding_cuts_and_rebuilds(shape, spec):
    mesh = make_mesh_for(8, model_par=4, device="cpu")
    sh = NamedSharding(mesh, PartitionSpec(*spec))
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape) + 1
    st = sh.shard(x)
    assert len(st.blocks) == mesh.size
    assert all(tuple(b.shape) == sh.shard_shape(shape) for b in st.blocks)
    assert torch.equal(st.full(), x)
    # block (data d, model m) of a dim split over (data, model) is d*4+m
    if spec and spec[0] == ("data", "model"):
        assert torch.equal(st.blocks[5], x[5:6])


# ---------------------------------------------------------------------------
# mapsin_embed against the reference's shard_map, 8 host devices
# ---------------------------------------------------------------------------

# (name, vocab, width, dtype, token shape, mesh: "model" | "data" | "none")
EMBED_CASES = [
    ("f32", 64, 16, "float32", (3, 10), "model"),
    ("bf16", 256, 32, "bfloat16", (2, 5, 7), "model"),
    ("uneven", 60, 16, "float32", (2, 9), "model"),      # 60 % 8: dense
    ("no-model-axis", 64, 16, "float32", (2, 9), "data"),  # dense
    ("no-mesh", 64, 16, "float32", (2, 9), "none"),         # dense
]

_EMBED_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.models.embedding import mapsin_embed
    spec = json.loads(sys.argv[1])
    data = np.load(spec["inp"])
    meshes = {"model": Mesh(np.array(jax.devices()[:8]), ("model",)),
              "data": Mesh(np.array(jax.devices()[:8]), ("data",)),
              "none": None}
    out = {}
    for name, _, _, dtype, _, mesh in spec["cases"]:
        table = jnp.asarray(data[name + "/table"]).astype(dtype)
        tok = jnp.asarray(data[name + "/tok"])
        f = lambda t: mapsin_embed(t, tok, meshes[mesh], None)
        out[name + "/out"] = np.asarray(f(table).astype(jnp.float32))
        if dtype == "float32":
            w = jnp.asarray(data[name + "/w"])
            out[name + "/grad"] = np.asarray(
                jax.grad(lambda t: (f(t) * w).sum())(table))
    np.savez(spec["out"], **out)
    print("ok")
""")


def _embed_inputs(name, v, d, shape, mesh):
    rng = np.random.RandomState(len(name) * 7 + v)
    tok = rng.randint(0, v, shape).astype(np.int32)
    if mesh == "model" and v % 8 == 0:
        # ids no shard owns give a zero row in both packages
        tok.flat[0], tok.flat[1], tok.flat[2] = v, v + 5, -1
    tok.flat[3] = tok.flat[4]                       # a repeated id
    table = rng.randn(v, d).astype(np.float32)
    if "bf16" in name:                              # exact bfloat16 values
        table = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    w = rng.randn(*shape, d).astype(np.float32)
    return table, tok, w


@pytest.fixture(scope="module")
def embed_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("embed8")
    arrays = {}
    for name, v, width, _, shape, mesh in EMBED_CASES:
        table, tok, w = _embed_inputs(name, v, width, shape, mesh)
        arrays.update({name + "/table": table, name + "/tok": tok,
                       name + "/w": w})
    np.savez(d / "inp.npz", **arrays)
    spec = dict(inp=str(d / "inp.npz"), out=str(d / "out.npz"),
                cases=EMBED_CASES)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _EMBED_REFERENCE,
                          json.dumps(spec)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(inputs=arrays, outputs=dict(np.load(d / "out.npz")))


def _port_mesh(kind, form):
    if kind == "none":
        return None
    if kind == "data":
        return LocalMesh(8, "cpu", axis="data")
    if form == "local":
        return LocalMesh(8, "cpu", axis="model")
    return make_mesh_for(8, model_par=8, device="cpu")


@pytest.mark.parametrize("form", ["local", "mesh"])
@pytest.mark.parametrize("case", EMBED_CASES, ids=[c[0] for c in EMBED_CASES])
def test_mapsin_embed_matches_reference(embed_reference, case, form):
    name, v, width, dtype, shape, kind = case
    inp, ref = embed_reference["inputs"], embed_reference["outputs"]
    table = torch.from_numpy(inp[name + "/table"]).to(dtype_of(dtype))
    tok = torch.from_numpy(inp[name + "/tok"])
    mesh = _port_mesh(kind, form)
    runs = []
    real_run = collectives.LocalMesh.run

    def counting_run(self, body):
        runs.append(self.shape)
        return real_run(self, body)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(collectives.LocalMesh, "run", counting_run)
        got = embedding.embed(table, tok, "mapsin", mesh)
    # the sharded body ran only where the reference's shard_map does
    assert runs == ([{"model": 8}] if kind == "model" and v % 8 == 0 else [])
    assert got.dtype == table.dtype and got.shape == (*shape, width)
    np.testing.assert_array_equal(got.float().numpy(), ref[name + "/out"])
    if dtype != "float32":
        return
    w = torch.from_numpy(inp[name + "/w"])
    t = table.clone().requires_grad_()
    (embedding.embed(t, tok, "mapsin", mesh) * w).sum().backward()
    want = ref[name + "/grad"]
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if kind == "model" and v % 8 == 0:
        # the dense gather's gradient, for the ids both look up
        ok = (tok >= 0) & (tok < v)
        dense = table.clone().requires_grad_()
        (embedding.dense_embed(dense, tok.clamp(0, v - 1)) * w
         * ok[..., None]).sum().backward()
        assert torch.equal(t.grad, dense.grad)
    with torch.no_grad():
        assert embedding.embed(t, tok, "mapsin", mesh).grad_fn is None
    with torch.inference_mode():
        assert embedding.embed(t, tok, "mapsin", mesh).is_inference()


def test_embed_rejects_unknown_impl():
    with pytest.raises(ValueError, match="embedding_impl"):
        embedding.embed(torch.zeros(4, 2), torch.zeros(1, dtype=torch.long),
                        "sparse")


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------


def test_elastic_round_trip_is_exact(tmp_path):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen3-8b")),
                              param_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    save(str(tmp_path / "a"), 3, {"params": params})
    mesh = make_mesh_for(8, model_par=4, device="cpu")
    rules = make_rules(mesh, cfg)
    defs = model.param_defs()
    # meta templates in float32: the restore keeps the checkpoint's dtype
    templates = {"params": _retyped(abstract_tree(defs), torch.float32)}
    step, out = load(os.path.join(tmp_path / "a", "step_00000003"), templates,
                     {"params": sharding_tree(defs, rules)})
    assert step == 3
    shard0 = 0
    for (path, st), (_, want) in zip(tree_paths(out["params"]),
                                     tree_paths(params)):
        assert isinstance(st, ShardedTensor), path
        assert st.dtype == want.dtype == torch.bfloat16
        block = st.sharding.shard_shape(want.shape)
        assert all(tuple(b.shape) == block for b in st.blocks), path
        assert torch.equal(st.full(), want), path
        shard0 += st.blocks[0].numel() * st.blocks[0].element_size()
    assert shard0 == sharded_bytes_per_device(defs, rules)
    # save from the mesh, load with none: back bit for bit, cast as asked
    save(str(tmp_path / "b"), 4, {"params": out["params"]})
    _, back = load(os.path.join(tmp_path / "b", "step_00000004"),
                   {"params": params}, device="cpu")
    for (path, got), (_, want) in zip(tree_paths(back["params"]),
                                      tree_paths(params)):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    _, cast = load(os.path.join(tmp_path / "b", "step_00000004"),
                   {"params": _retyped(params, torch.float32)}, device="cpu")
    assert cast["params"]["embed"].dtype == torch.float32


def _retyped(tree, dtype):
    from repro_torch.common import tree_map_with_path
    return tree_map_with_path(lambda _, t: t.to(dtype), tree)


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = j_reduce(j_get_config("qwen3-8b")), reduce_for_smoke(get_config("qwen3-8b"))
    assert cfg.embedding_impl == jcfg.embedding_impl == "mapsin"
    jparams = init_tree(j_build_model(jcfg).param_defs(), jax.random.key(0))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.1] = -1
    mesh = make_mesh_for(8, model_par=4, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                np_params=jax.tree.map(np.asarray, jparams),
                batch={"tokens": toks, "labels": labels}, mesh=mesh,
                rules=make_rules(mesh, cfg))


def _within_step_bounds(got_params, jparams, lr):
    """tests/test_torch_train.py's train-step bounds."""
    got = dict(tree_paths(got_params))
    for path, want in j_tree_paths(jparams):
        d = np.abs(got[path].detach().float().numpy() - np.asarray(want))
        assert d.max() <= 2 * lr * 1.01 + 1e-6, path
        assert (d > 1e-6).mean() <= 1e-3, path


def test_train_step_on_a_mesh_matches_reference(qwen):
    runs = []
    real_run = collectives.LocalMesh.run

    def counting_run(self, body):
        runs.append(self.shape)
        return real_run(self, body)

    jmodel = j_build_model(qwen["jcfg"])
    jstep = jax.jit(japi.make_train_step(jmodel, JOptConfig(**OPT)))
    jstate = jadamw.init_opt_state(qwen["jparams"], JOptConfig(**OPT))
    jp, _, jm = jstep(qwen["jparams"], jstate,
                      {k: jnp.asarray(v) for k, v in qwen["batch"].items()})
    model = build_model(qwen["cfg"], qwen["mesh"], qwen["rules"])
    assert model.device.type == "cpu"
    params = params_from_numpy(qwen["np_params"], "cpu")
    step = make_train_step(model, OptConfig(**OPT))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(collectives.LocalMesh, "run", counting_run)
        tp, _, m = step(params, init_opt_state(params, OptConfig(**OPT)),
                        {k: torch.from_numpy(v) for k, v in qwen["batch"].items()})
    assert runs == [{"model": 4}]              # the sharded lookup ran once
    for k in m:
        want = float(jm[k])
        assert abs(float(m[k]) - want) <= 1e-5 * abs(want), k
    _within_step_bounds(tp, jp, float(jm["lr"]))


def test_trainer_on_a_mesh_matches_reference(qwen, tmp_path):
    """One Trainer step on the mesh, from the reference Trainer's own
    initial weights (a step-0 checkpoint), against the reference Trainer's
    first step; then three steps on the mesh equal bit for bit to three
    without it."""
    shape, jshape = ShapeConfig("t", S, B, "train"), \
        dataclasses.replace(J_SHAPES["train_4k"], seq_len=S, global_batch=B)
    jtrainer = JTrainer(qwen["jcfg"], jshape, str(tmp_path / "jax"),
                        JOptConfig(**OPT), ckpt_every=100)
    jp, _, jm = jtrainer.run(1)
    start = params_from_numpy(qwen["np_params"], "cpu")
    init = {"params": start, "opt_state": init_opt_state(start, OptConfig(**OPT))}
    for d in ("mesh", "mesh3", "plain3"):
        save(str(tmp_path / d), 0, init)
    mk = lambda d, **kw: Trainer(qwen["cfg"], shape, str(tmp_path / d),
                                 OptConfig(**OPT), ckpt_every=100,
                                 device="cpu", **kw)
    on_mesh = dict(mesh=qwen["mesh"], rules=qwen["rules"])
    p1, _, m1 = mk("mesh", **on_mesh).run(1)
    assert abs(float(m1["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    _within_step_bounds(p1, jp, float(jm["lr"]))
    p3, s3, m3 = mk("mesh3", **on_mesh).run(3)
    q3, t3, n3 = mk("plain3").run(3)
    for k in m3:
        assert torch.equal(m3[k], n3[k]), k
    for (path, a), (_, b) in zip(tree_paths((p3, s3)), tree_paths((q3, t3))):
        assert torch.equal(a, b), path
