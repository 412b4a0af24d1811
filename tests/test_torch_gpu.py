"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit (the kernels are built
with nvcc at first use). Without a card they skip; run them on a machine with
one (``--noconftest``: ``tests/conftest.py`` imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.sparse as TS
from repro_torch.core.bfs import _adj_global, bfs_local
from repro_torch.core.gsana import pair_tasks
from repro_torch.engine import (
    BFSInputs, CudaSubstrate, GSANAInputs, LocalSubstrate, Request, SpMVInputs, run,
)
from repro_torch.kernels.bfs.kernel import bfs_expand, bfs_expand_plain
from repro_torch.kernels.bfs.ops import bfs_cuda
from repro_torch.kernels.spmv.kernel import spmv_ell, spmv_ell_plain
from repro_torch.kernels.spmv.ops import spmv
from repro_torch.kernels.topk_sim.kernel import topk_sim, topk_sim_plain
from repro_torch.kernels.topk_sim.ops import pair_planes

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card; decided here, at run time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares each CUDA kernel with its plain version")
    return torch.device("cuda")


@pytest.mark.parametrize("block_rows", [1, 7, 64, 256, 1024])
def test_spmv_ell_kernel_matches_plain(cuda, block_rows):
    a = T.partition_ell(TS.laplacian_2d(48, device=cuda), 8, device=cuda)
    cols, vals = a.cols.reshape(-1, a.k), a.vals.reshape(-1, a.k)
    x = torch.randn(a.shape[1], generator=torch.Generator().manual_seed(0)).to(cuda)
    before = spmv_ell.launches
    y = spmv_ell(cols, vals, x, block_rows=block_rows)
    assert spmv_ell.launches == before + 1
    torch.testing.assert_close(y, spmv_ell_plain(cols, vals, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["stripe", "auto"])
def test_spmv_stripe_kernel_matches_csr_reference(cuda, variant):
    a = TS.skewed_matrix(3000, 4.0, 300, seed=4, device=cuda)
    e = T.partition_ell(a, 1, device=cuda)
    x = torch.randn(3000, generator=torch.Generator().manual_seed(1)).to(cuda)
    y = spmv(e.cols[0], e.vals[0], x, grain=64, variant=variant)
    torch.testing.assert_close(y, TS.spmv_csr_ref(a, x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block_rows", [1, 3, 256, 2048])
def test_bfs_expand_kernel_bit_identical(cuda, block_rows):
    g = TS.partition_graph(TS.edges_to_csr(TS.rmat_edges(12, 8, seed=2), 1 << 12, device=cuda),
                           8, device=cuda)
    adj = _adj_global(g)
    gen = torch.Generator().manual_seed(block_rows)
    frontier = (torch.rand(adj.shape[0], generator=gen) < 0.1).to(cuda)
    before = bfs_expand.launches
    got = bfs_expand(adj, frontier, block_rows=block_rows)
    assert bfs_expand.launches == before + 1
    assert torch.equal(got, bfs_expand_plain(adj, frontier))
    parents = bfs_cuda(g, 0, block_rows=block_rows)
    assert torch.equal(parents, bfs_local(g, 0))
    assert T.validate_parents(g, 0, parents)


@pytest.mark.parametrize("n", [1024, 8192])
def test_topk_sim_kernel_matches_plain(cuda, n):
    vs1, vs2, _ = T.generate_alignment_pair(n, seed=3, device=cuda)
    grid = T.pick_grid(n, 32)
    b1, b2 = T.bucketize(vs1, grid, device=cuda), T.bucketize(vs2, grid, device=cuda)
    planes = pair_planes(vs1, vs2, b1, b2, *pair_tasks(grid, cuda))[:4]
    kw = dict(t1=16, t2=16, t3=64, k=4)
    before = topk_sim.launches
    s, i = topk_sim(*planes, **kw)
    assert topk_sim.launches == before + 1
    s_p, i_p = topk_sim_plain(*planes, **kw)
    assert torch.equal(i, i_p)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-6)


def test_engine_cuda_matches_local_on_the_card(cuda):
    a = TS.laplacian_2d(64, device=cuda)
    x = torch.randn(a.n_cols, generator=torch.Generator().manual_seed(2)).to(cuda)
    spmv_in = SpMVInputs(T.partition_ell(a, 8, device=cuda), x)
    g = TS.partition_graph(TS.edges_to_csr(TS.erdos_renyi_edges(12, 8), 1 << 12, device=cuda),
                           8, device=cuda)
    vs1, vs2, pi = T.generate_alignment_pair(2048, seed=1, device=cuda)
    grid = T.pick_grid(2048, 32)
    cap = max(T.bucketize(vs1, grid, device=cuda).cap, T.bucketize(vs2, grid, device=cuda).cap)
    gi = GSANAInputs(vs1, vs2, T.bucketize(vs1, grid, cap=cap, device=cuda),
                     T.bucketize(vs2, grid, cap=cap, device=cuda), ground_truth=pi)
    local, card = LocalSubstrate(cuda), CudaSubstrate(cuda)
    for rep in (True, False):
        st = T.MigratoryStrategy(replicate_x=rep)
        y_l, _ = run(Request("spmv", spmv_in, st, local))
        y_c, _ = run(Request("spmv", spmv_in, st, card))
        torch.testing.assert_close(y_c, y_l, rtol=1e-5, atol=1e-5)
    for comm in T.Comm:
        st = T.MigratoryStrategy(comm=comm)
        p_l, _ = run(Request("bfs", BFSInputs(g, 0), st, local))
        p_c, _ = run(Request("bfs", BFSInputs(g, 0), st, card))
        assert torch.equal(p_l, p_c)
    (c_l, s_l), _ = run(Request("gsana", gi, None, local))
    (c_c, s_c), rep = run(Request("gsana", gi, None, card))
    assert torch.equal(c_l, c_c)
    torch.testing.assert_close(s_c, s_l, rtol=0, atol=1e-6)
    assert rep.metrics["recall_at_k"] > 0.9


def test_wrappers_raise_instead_of_falling_back(cuda):
    cols = torch.zeros((4, 2), dtype=torch.int64, device=cuda)  # the kernel takes int32
    vals = torch.zeros((4, 2), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        spmv_ell(cols, vals, torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="all be on CUDA"):
        spmv_ell(cols.int(), vals, torch.zeros(4))
    planes = [torch.zeros((1, 4, 101), device=cuda), torch.zeros((1, 2, 101), device=cuda),
              torch.ones((1, 4), device=cuda), torch.ones((1, 2), device=cuda)]
    with pytest.raises(ValueError, match="unsupported shape"):
        topk_sim(*planes, t1=16, t2=16, t3=64, k=4)  # k > B
    assert np.isfinite(topk_sim(*planes, t1=16, t2=16, t3=64, k=2)[0].cpu().numpy()).all()
