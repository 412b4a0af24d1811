"""rwkv6 (the ssm family) on the port's ``(data, model)`` mesh against the
JAX package's sharded programs (``tests/torch_lm_mesh_families.py``). The
reduced config has 2 heads: on the (4, 2) mesh each rank runs the time
mix's scan over its one head; on the (2, 4) mesh, where the heads do not
divide ``model``, they are padded to 4 as GSPMD pads the split, each rank
runs one, and the decode state holds both on every rank."""
from torch_lm_mesh_families import (  # noqa: F401 (fixtures)
    _close_meshes, _time_limit, check_init, check_serve, check_train, world,
)

ARCH = "rwkv6-3b"


def test_prefill_decode_and_state_match_the_reference_mesh(world):
    shape, mesh, ref = world
    check_serve(mesh, ref, ARCH)


def test_loss_grads_and_train_step_match_the_reference_mesh(world):
    shape, mesh, ref = world
    check_train(mesh, ref, ARCH)


def test_ranks_draw_the_unsharded_model_from_the_seed(world):
    shape, mesh, ref = world
    check_init(mesh, ARCH)
