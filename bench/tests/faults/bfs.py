"""The BFS op's timed path broken underneath: ``broken(fault)`` gives the
``repro_torch.engine.substrate`` attribute to replace, ``bfs_cuda``, and a
search that starts and never moves, expands half of every frontier, or makes
a vertex its own parent."""
import torch


def broken(fault: str):
    from repro_torch.core.bfs import UNVISITED, _finalize_parents, bfs_rounds
    from repro_torch.kernels.bfs.kernel import bfs_expand
    from repro_torch.kernels.bfs.ops import bfs_cuda as real

    def bfs_cuda(g, root, strategy=None, max_rounds=None):
        n = g.P * g.v_per_nodelet
        if fault == "state_unchanged":  # the parents as the search starts
            par = torch.full((n,), UNVISITED, dtype=torch.int32)
            par[root] = root
            return _finalize_parents(g, par)
        if fault == "half_left_out":  # half of every frontier never expands
            keep = torch.arange(n) % 2 == 0
            expand = lambda a, f: bfs_expand(a, f & keep)  # noqa: E731
            return _finalize_parents(g, bfs_rounds(g.adj, root, max_rounds or n, expand, n))
        par = real(g, root, strategy, max_rounds)
        v = (root + 1) % g.n_vertices
        par[v] = v  # answer_altered: a vertex made its own parent
        return par

    return "bfs_cuda", bfs_cuda
