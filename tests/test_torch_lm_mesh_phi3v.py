"""phi-3-vision (the vlm family: the transformer's mesh branches, the stub
patches before the prompt) on the port's ``(data, model)`` mesh against
the JAX package's sharded programs (``tests/torch_lm_mesh_families.py``):
prefill logits and caches over the patches and the prompt, 4 decode steps,
the loss over the token positions and every gradient, one train step. The
flash branch (its plain version here) holds the same."""
from torch_lm_mesh_families import (  # noqa: F401 (fixtures)
    _close_meshes, _time_limit, check_init, check_serve, check_train, world,
)

ARCH = "phi-3-vision-4.2b"


def test_prefill_decode_and_caches_match_the_reference_mesh(world):
    shape, mesh, ref = world
    check_serve(mesh, ref, ARCH)
    check_serve(mesh, ref, ARCH, attn_impl="flash")


def test_loss_grads_and_train_step_match_the_reference_mesh(world):
    shape, mesh, ref = world
    check_train(mesh, ref, ARCH)


def test_ranks_draw_the_unsharded_model_from_the_seed(world):
    shape, mesh, ref = world
    check_init(mesh, ARCH)
