"""The frozen byte counts against hand-worked values, and the benchmark's
input layouts against the program's own builders at tiny sizes."""
import numpy as np
import torch

from bench.ops import bfs as bfs_op
from bench.ops import spmv as spmv_op
from bench.reference import bfs as bfs_ref
from bench.reference import spmv as spmv_ref


def test_spmv_bytes_of_a_4x4_laplacian():
    # grid 4: 16 rows; 16 diagonal + 2 * 2 * 4 * 3 neighbour entries = 64 non-zeros
    assert 5 * 16 - 4 * 4 == 64
    assert spmv_op.spmv_useful_bytes(64, 16, 16) == 64 * 8 + 32 * 4 == 640


def test_spmv_bytes_of_the_benchmark_size():
    n = 4096
    assert spmv_op.spmv_useful_bytes(5 * n * n - 4 * n, n * n, n * n) == 805_175_296


def test_bfs_bytes_of_a_16_vertex_graph():
    # a 4 x 4 grid graph: 24 undirected edges, 48 adjacency entries, all reached
    assert bfs_op.bfs_useful_bytes(48) == 768
    assert bfs_op.bfs_roofline_bytes(48, 16) == 48 * 4 + 16 * 4 == 256


def test_laplacian_planes_equal_the_programs_partition():
    from repro_torch.core.spmv import partition_ell
    from repro_torch.sparse.gen import laplacian_2d

    for n, p in ((4, 8), (16, 8), (6, 4)):
        mine = spmv_op.laplacian_planes(n, p, "cpu")
        theirs = partition_ell(laplacian_2d(n, device="cpu"), p, device="cpu")
        assert torch.equal(mine.cols, theirs.cols)
        assert torch.equal(mine.vals, theirs.vals)
        assert mine.shape == theirs.shape


def test_graph_planes_equal_the_programs_partition():
    from repro_torch.sparse.gen import edges_to_csr
    from repro_torch.sparse.graph import partition_graph

    gen = torch.Generator().manual_seed(3)
    keys, src, dst = bfs_op.er_graph(6, 4, gen, "cpu")
    mine = bfs_op.partitioned(src, dst, 64, 8)
    # the same edges through the program's host builders
    theirs = partition_graph(edges_to_csr(np.stack([src.numpy(), dst.numpy()], 1), 64,
                                          symmetrize=False, device="cpu"), 8, device="cpu")
    assert torch.equal(mine.adj, theirs.adj)
    assert torch.equal(mine.deg, theirs.deg)


def test_grid_graph_levels_and_validation_by_hand():
    # 4 x 4 grid, root 0: depth of (i, j) is i + j
    e = [(r * 4 + c, r * 4 + c + 1) for r in range(4) for c in range(3)]
    e += [(r * 4 + c, (r + 1) * 4 + c) for r in range(3) for c in range(4)]
    src = torch.tensor([a for a, b in e] + [b for a, b in e])
    dst = torch.tensor([b for a, b in e] + [a for a, b in e])
    order = torch.argsort(src * 16 + dst)
    src, dst = src[order], dst[order]
    lv = bfs_ref.levels(src, dst, 16, 0)
    assert lv.tolist() == [i + j for i in range(4) for j in range(4)]
    par = bfs_ref.parents(src, dst, 16, 0)
    keys = src * 16 + dst
    assert bfs_ref.bad_vertices(par, keys, 16, 0, lv) == 0
    wrong = par.clone()
    wrong[15] = 0  # not a neighbour of 15
    assert bfs_ref.bad_vertices(wrong, keys, 16, 0, lv) == 1
    short = bfs_ref.parents(src, dst, 16, 0, max_rounds=5)
    assert bfs_ref.bad_vertices(short, keys, 16, 0, lv) == 1  # vertex 15, depth 6


def test_laplacian_reference_by_hand():
    x = torch.arange(9, dtype=torch.float32)
    y = spmv_ref.laplacian_apply(x, 3)
    # centre (1, 1) = 4 * 4 - (1 + 7 + 3 + 5); corner (0, 0) = 0 - (1 + 3)
    assert y[4].item() == 0.0 and y[0].item() == -4.0
    assert spmv_ref.max_rel_error(y.float(), x, 3) == 0.0
