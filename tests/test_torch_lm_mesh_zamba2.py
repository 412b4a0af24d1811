"""zamba2 (the hybrid family, Mamba-2 layers and one shared attention
block) on the port's ``(data, model)`` mesh against the JAX package's
sharded programs (``tests/torch_lm_mesh_families.py``). The reduced config
runs at ``ssm_chunk`` 16, where the reference's gradients are finite, and
its train step at 2 microbatches (``MICROBATCHES``)."""
from repro_torch.configs import reduced_config
from repro_torch.convert import shard_params
from repro_torch.launch.steps import MICROBATCHES
from repro_torch.models import api, zamba2
from repro_torch.models.sharding import make_rules
from torch_lm_mesh_families import (  # noqa: F401 (fixtures)
    _close_meshes, _time_limit, check_init, check_serve, check_train, world,
)

ARCH = "zamba2-2.7b"


def test_prefill_decode_and_caches_match_the_reference_mesh(world):
    shape, mesh, ref = world
    check_serve(mesh, ref, ARCH)
    check_serve(mesh, ref, ARCH, attn_impl="flash")


def test_loss_grads_and_train_step_match_the_reference_mesh(world):
    shape, mesh, ref = world
    assert MICROBATCHES[ARCH] == 2
    check_train(mesh, ref, ARCH)


def test_ranks_draw_the_unsharded_model_from_the_seed(world):
    shape, mesh, ref = world
    check_init(mesh, ARCH)


def test_the_shared_block_is_laid_out_once_not_per_layer():
    """The shared block has no layer dim: its specs are the reference's
    ``("fsdp", "heads")`` and kin, one entry a weight, and each rank's
    block of it is a quarter of the whole on a (2, 2) mesh."""
    cfg = reduced_config(ARCH)
    specs = api.param_specs(cfg)
    shared = {n: s for n, s in specs.items() if n.startswith("shared_attn.")}
    assert shared == {f"shared_attn.{n}": s for n, s in zamba2.shared_attn_specs().items()}
    assert shared["shared_attn.attn.wq"] == ("fsdp", "heads")
    assert not any(n.startswith("blocks.") and "attn" in n for n in specs)
    model = api.init_params(cfg, device="cpu")
    named = {n: p.detach() for n, p in model.named_parameters()}
    sizes = {"data": 2, "model": 2}
    rules = make_rules(sizes, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                       vocab_size=cfg.vocab_size)
    blocks = shard_params(named, cfg, rules, {"data": 1, "model": 0}, sizes)
    wq = named["shared_attn.attn.wq"]
    assert blocks["shared_attn.attn.wq"].shape == (wq.shape[0] // 2, wq.shape[1] // 2)
    assert (blocks["shared_attn.attn.wq"] == wq[wq.shape[0] // 2:, :wq.shape[1] // 2]).all()
