"""The port's sharding rules, spec tables, shapes and re-mesh plan
(``repro_torch.models.sharding``, the families' ``param_specs`` /
``cache_specs`` / ``state_specs``, ``models/api.py``'s spec builders,
``configs/shapes.py``, ``runtime/elastic.py``) against the JAX package's.

The reference's ``make_rules`` reads only a mesh's axis names and sizes, so
it is given a ``jax.sharding.AbstractMesh`` of each shape: no devices are
needed, even at (2, 16, 16)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as JC
import repro.configs.shapes as JS
import repro.models.api as JA
import repro.models.sharding as JSH
import repro.runtime.elastic as JE
import repro_torch.configs as TC
import repro_torch.configs.shapes as TS
import repro_torch.models.sharding as TSH
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import api as TA
from repro_torch.runtime import ElasticPlan, plan_remesh

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model")), ((1, 1), ("data", "model"))]
CONFIGS = sorted([*TC.ARCHS, *TC.AUX_CONFIGS])
VARIANTS = [dict(), dict(seq_shard=True), dict(long_context=True)]
STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _rule_kwargs(cfg) -> dict:
    return dict(num_experts=cfg.num_experts, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, vocab_size=cfg.vocab_size)


@pytest.mark.parametrize("variant", VARIANTS, ids=["plain", "seq_shard", "long_context"])
@pytest.mark.parametrize("shape,axes", MESHES, ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("arch", CONFIGS)
def test_make_rules_equals_reference(arch, shape, axes, variant):
    cfg = TC.get_config(arch)
    ref = JSH.make_rules(AbstractMesh(shape, axes), **_rule_kwargs(cfg), **variant)
    got = TSH.make_rules(dict(zip(axes, shape)), **_rule_kwargs(cfg), **variant)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for name in (f.name for f in dataclasses.fields(TSH.Rules)):
        assert got.spec(name, None) == tuple(ref.spec(name, None)), name


def test_mesh_shape_description_and_rules_input():
    """``make_production_mesh`` is a description (no processes); the rules
    read it as the reference's read a mesh."""
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.shape, single.size) == ({"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    cfg = TC.get_config("moonshot-v1-16b-a3b")
    ref = JSH.make_rules(AbstractMesh((2, 16, 16), ("pod", "data", "model")), **_rule_kwargs(cfg))
    assert dataclasses.asdict(TSH.make_rules(multi, **_rule_kwargs(cfg))) == dataclasses.asdict(ref)
    assert isinstance(MeshShape((4, 2), ("data", "model")).shape, dict)


def _flat(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", v


def _ref_specs_by_name(cfg) -> dict:
    """The reference's param_specs keyed by the port's names: a stacked
    entry once a layer, its leading L dim dropped."""
    layers = {"blocks": cfg.num_layers, "enc_blocks": cfg.encoder_layers,
              "dec_blocks": cfg.num_layers}
    out = {}
    for path, spec in _flat(JA.param_specs(cfg)):
        top, _, rest = path.partition(".")
        if top in STACKS:
            assert spec[0] is None, path
            for i in range(layers[top]):
                out[f"{top}.{i}.{rest}"] = tuple(spec[1:])
        else:
            out[path] = tuple(spec)
    return out


@pytest.mark.parametrize("arch", CONFIGS)
def test_param_specs_name_every_parameter_and_equal_the_reference(arch):
    cfg = JC.reduced_config(arch) if arch in JC.ARCHS else JC.get_config(arch)
    tcfg = TC.reduced_config(arch) if arch in TC.ARCHS else TC.get_config(arch)
    specs = TA.param_specs(tcfg)
    names = {n for n, _ in TA.abstract_params(tcfg).named_parameters()}
    assert set(specs) == names
    ref = _ref_specs_by_name(cfg)
    assert specs == ref


@pytest.mark.parametrize("arch", CONFIGS)
def test_decode_state_specs_equal_the_reference(arch):
    cfg = JC.reduced_config(arch) if arch in JC.ARCHS else JC.get_config(arch)
    tcfg = TC.reduced_config(arch) if arch in TC.ARCHS else TC.get_config(arch)
    ref, got = JA.decode_state_specs(cfg), TA.decode_state_specs(tcfg)
    assert got._fields == ref._fields
    assert tuple(got) == tuple(tuple(s) for s in ref)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_input_specs_and_abstract_params_match_the_reference(arch, kind):
    """Meta tensors of the shapes and types the reference's
    ShapeDtypeStructs give (the decode state's fields too), and the meta
    model's parameters those of the reference's abstract tree, a layer at
    a time."""
    cfg, tcfg = JC.reduced_config(arch), TC.reduced_config(arch)
    ref = JA.input_specs(cfg, kind, 64, 4)
    got = TA.input_specs(tcfg, kind, 64, 4)
    assert set(got) == set(ref)
    for name, spec in ref.items():
        if name == "state":
            for field in spec._fields:
                want = getattr(spec, field)
                have = getattr(got["state"], field)
                if field == "length":
                    continue
                assert tuple(have.shape) == tuple(want.shape), field
                assert have.device.type == "meta"
                assert str(have.dtype).split(".")[-1] == str(np.dtype(want.dtype)), field
            continue
        have = got[name]
        assert have.device.type == "meta"
        assert tuple(have.shape) == tuple(spec.shape)
        assert str(have.dtype).split(".")[-1] == str(np.dtype(spec.dtype)), name
    shapes = {}
    for path, leaf in _flat(jax.tree.map(lambda a: a, JA.abstract_params(cfg))):
        top, _, rest = path.partition(".")
        if top in STACKS:
            for i in range(leaf.shape[0]):
                shapes[f"{top}.{i}.{rest}"] = tuple(leaf.shape[1:])
        else:
            shapes[path] = tuple(leaf.shape)
    assert {n: tuple(p.shape) for n, p in TA.abstract_params(tcfg).named_parameters()} == shapes


def test_shapes_applicable_and_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in TS.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JS.SHAPES.items()}
    for arch in JC.ARCHS:
        for name in JS.SHAPES:
            assert TS.applicable(TC.get_config(arch), TS.SHAPES[name]) == \
                JS.applicable(JC.get_config(arch), JS.SHAPES[name])
    assert TS.cells(TC.ARCHS) == JS.cells(JC.ARCHS)
    assert TC.SHAPES is TS.SHAPES


PLANS = [
    (400, 16, 256, 16, 0.8), (6, 2, 256, 4, 0.8), (16, 16, 256, 8, 0.8), (200, 16, 256, 16, 0.8),
    (8, 2, 64, 16, 1.0), (8, 2, 64, 16, 0.2), (64, 2, 256, 8, 0.8), (4, 2, 8, 2, 0.8),
    (2, 2, 8, 2, 0.8), (3, 1, 16, 4, 0.5), (512, 16, 256, 32, 0.8), (1, 1, 1, 1, 0.8),
    (8, 16, 256, 16, 0.8), (1, 2, 256, 2, 0.8), (15, 16, 256, 16, 0.8),
]


@pytest.mark.parametrize("n_healthy,model_axis,global_batch,prev_data_axis,headroom", PLANS)
def test_plan_remesh_equals_the_reference(n_healthy, model_axis, global_batch, prev_data_axis,
                                          headroom):
    args = (n_healthy, model_axis, global_batch, prev_data_axis, headroom)
    try:
        ref = JE.plan_remesh(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match="cannot preserve model axis"):
            plan_remesh(*args)
        assert "cannot preserve model axis" in str(e)
        return
    got = plan_remesh(*args)
    assert isinstance(got, ElasticPlan)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_block_of_and_unblock_round_trip():
    """Every rank's block of a tensor, put back whole, is the tensor; a
    dim over two axes takes its blocks major axis first."""
    sizes = {"data": 2, "model": 3}
    t = torch.arange(6 * 12 * 5, dtype=torch.float32).reshape(6, 12, 5)
    with pytest.raises(ValueError, match="does not divide"):
        TSH.block_of(t, (None, None, "model"), {"data": 0, "model": 0}, sizes)  # 5 over 3
    spec = ("model", ("data",), None)
    coords = [{"data": d, "model": m} for d in range(2) for m in range(3)]
    blocks = [TSH.block_of(t, spec, c, sizes) for c in coords]
    assert blocks[4].shape == (2, 6, 5)
    assert torch.equal(blocks[4], t[2:4, 6:12])
    assert torch.equal(TSH.unblock(blocks, coords, spec, sizes), t)
    two = (None, ("data", "model"), None)
    blocks = [TSH.block_of(t, two, c, sizes) for c in coords]
    assert torch.equal(blocks[4], t[:, 8:10])  # data 1, model 1: block 1 * 3 + 1
    assert torch.equal(TSH.unblock(blocks, coords, two, sizes), t)
