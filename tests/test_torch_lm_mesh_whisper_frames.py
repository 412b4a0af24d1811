"""whisper on a mesh whose ``model`` axis does not divide the encoder's
frames (10 frames over 4, as 1500 over 16 at full width): the encoder pads
them to 12 and keeps the padding out of every softmax, as GSPMD pads the
uneven dim in the JAX package's sharded programs. Prefill logits (the
reference attention branch and the flash branch's plain version), the
decode state after each step (the cross caches over the 10 frames), the
loss, every gradient and one train step against the reference's on the
(2, 4) mesh (``tests/torch_lm_mesh_families.py``)."""
import pytest

from repro_torch.launch.mesh import make_mesh
from torch_lm_mesh_families import (  # noqa: F401 (fixtures)
    MESH_TIMEOUT_S, _close_meshes, _time_limit, check_serve, check_train, reference,
)

ARCH, FRAMES, SHAPE = "whisper-small", 10, (2, 4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ref = reference(ARCH, SHAPE, tmp_path_factory.mktemp("ref_frames"), encoder_frames=FRAMES)
    mesh = make_mesh(SHAPE, ("data", "model"), device="cpu", timeout=MESH_TIMEOUT_S)
    try:
        yield mesh, ref
    finally:
        mesh.close()
        assert mesh.exit_codes == [0] * mesh.size


def test_uneven_frames_serve_like_the_reference_mesh(world):
    mesh, ref = world
    assert ref["frames"].shape[1] == FRAMES and FRAMES % SHAPE[1]
    check_serve(mesh, ref, ARCH, encoder_frames=FRAMES)
    check_serve(mesh, ref, ARCH, encoder_frames=FRAMES, attn_impl="flash")


def test_uneven_frames_train_like_the_reference_mesh(world):
    mesh, ref = world
    check_train(mesh, ref, ARCH, encoder_frames=FRAMES)
