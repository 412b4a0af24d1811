"""BFS in the PyTorch port against the JAX package, on the CPU.

Parent trees must be bit-identical: the merge is an integer min, which no
order of evaluation changes. Compared across both S2 comm strategies and
every block size of the reference's Pallas grid, on the port's ``local``
and ``cuda`` substrates (the latter runs the round kernel's plain version
here), against the JAX ``local`` and ``pallas`` (interpret mode) paths."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sparse as RS
import repro_torch.core as T
import repro_torch.sparse as TS
from repro.core.bfs import _adj_global as ref_adj_global
from repro.engine import PALLAS_BLOCK_CANDIDATES
from repro.engine import BFSInputs as JBFSInputs, Request as JRequest, run as jrun
from repro.kernels.bfs.kernel import bfs_expand_pallas
from repro.kernels.bfs.ref import bfs_expand_reference
from repro_torch.core.bfs import _adj_global as port_adj_global
from repro_torch.engine import BFSInputs, CudaSubstrate, LocalSubstrate, Request, run
from repro_torch.kernels.bfs.kernel import bfs_expand, bfs_expand_plain, bfs_search
from repro_torch.kernels.bfs.ops import bfs_cuda

CPU = "cpu"
GRAPHS = {
    "er8": (lambda mod: mod.erdos_renyi_edges(8, 6, seed=2), 256, 3),
    "rmat9": (lambda mod: mod.rmat_edges(9, 8, seed=3), 512, 0),
    "rmat10": (lambda mod: mod.rmat_edges(10, 8, seed=1), 1024, 5),
}
_CACHE: dict = {}
_REF_PARENTS: dict = {}


def problem(name: str):
    if name not in _CACHE:
        gen, n, root = GRAPHS[name]
        g_ref = RS.partition_graph(RS.edges_to_csr(gen(RS), n), 8)
        g = TS.partition_graph(TS.edges_to_csr(gen(TS), n, device=CPU), 8, device=CPU)
        _CACHE[name] = (JBFSInputs(g_ref, root), BFSInputs(g, root))
    return _CACHE[name]


def ref_parents(name: str, comm, substrate: str):
    key = (name, comm, substrate)
    if key not in _REF_PARENTS:
        ref_in, _ = problem(name)
        st = R.MigratoryStrategy(comm=R.Comm(comm.value))
        _REF_PARENTS[key] = jrun(JRequest("bfs", ref_in, st, substrate), iters=1, warmup=0)
    return _REF_PARENTS[key]


@pytest.mark.parametrize("grain", PALLAS_BLOCK_CANDIDATES)
@pytest.mark.parametrize("comm", list(T.Comm))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_parents_bit_identical(name, comm, grain):
    ref_in, port_in = problem(name)
    p_ref, rep_ref = ref_parents(name, comm, "local")
    st = T.MigratoryStrategy(comm=comm, grain=grain)
    for sub in (LocalSubstrate(CPU), CudaSubstrate(CPU)):
        parents, rep = run(Request("bfs", port_in, st, sub), iters=1, warmup=0)
        assert parents.dtype == torch.int32
        np.testing.assert_array_equal(parents.numpy(), np.asarray(p_ref))
        row, row_ref = rep.to_dict(), rep_ref.to_dict()
        for col in ("rounds", "edges_traversed", "reached", "migrations", "remote_writes",
                    "traffic_bytes", "bytes_moved"):
            assert row[col] == row_ref[col], col
        assert T.validate_parents(port_in.g, port_in.root, parents)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_matches_reference_pallas_substrate(name):
    _, port_in = problem(name)
    p_pallas, _ = ref_parents(name, T.Comm.REMOTE_WRITE, "pallas")
    parents = bfs_cuda(port_in.g, port_in.root)
    np.testing.assert_array_equal(parents.numpy(), np.asarray(p_pallas))


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
def test_bfs_max_rounds_cut(max_rounds):
    ref_in, port_in = problem("rmat9")
    p_ref = R.bfs_local(ref_in.g, ref_in.root, max_rounds=max_rounds)
    for sub in (LocalSubstrate(CPU), CudaSubstrate(CPU)):
        inputs = BFSInputs(port_in.g, port_in.root, max_rounds=max_rounds)
        parents, _ = run(Request("bfs", inputs, None, sub), iters=1, warmup=0)
        np.testing.assert_array_equal(parents.numpy(), np.asarray(p_ref))


@pytest.mark.parametrize("layout", ["planes", "rows"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_search_plain_cut_at_every_round_matches_reference(name, layout):
    """``bfs_search`` on CPU tensors (the kernel's plain version: the host
    round loop) on the (P, V_p, K) planes and on P = 1 rows, cut after each
    level from 1 to one past the depth: the JAX ``local`` substrate's cut."""
    ref_in, port_in = problem(name)
    adj = port_in.g.adj if layout == "planes" else port_adj_global(port_in.g).contiguous()
    n_vertices = port_in.g.n_vertices
    depth = R.bfs_traffic(ref_in.g, ref_in.root, R.MigratoryStrategy()).rounds
    for max_rounds in range(1, depth + 2):
        want = np.asarray(R.bfs_local(ref_in.g, ref_in.root, max_rounds=max_rounds))
        got = bfs_search(adj, port_in.root, block_rows=33, max_rounds=max_rounds)[:n_vertices]
        np.testing.assert_array_equal(torch.where(got == T.UNVISITED, -1, got).numpy(), want)


@pytest.mark.parametrize("block_rows", [1, 3, 64, 4096])
def test_expand_round_matches_reference_kernels(block_rows):
    ref_in, port_in = problem("rmat10")
    adj_ref = ref_adj_global(ref_in.g)
    adj = port_adj_global(port_in.g)
    frontier = np.random.default_rng(block_rows).random(adj.shape[0]) < 0.2
    want = np.asarray(bfs_expand_reference(adj_ref, frontier.astype(np.int32)))
    np.testing.assert_array_equal(
        np.asarray(bfs_expand_pallas(adj_ref, frontier.astype(np.int32), block_rows=block_rows,
                                     interpret=True)), want)
    for f in (torch.as_tensor(frontier), torch.as_tensor(frontier.astype(np.int32))):
        got = bfs_expand(adj, f, block_rows=block_rows)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(bfs_expand_plain(adj, f).numpy(), want)


def frontier_of(kind: str, n: int, seed: int) -> np.ndarray:
    """A frontier mask: random bool, all in, none in, or int32 with values
    other than 0 and 1 (nonzero = in)."""
    rng = np.random.default_rng(seed)
    return {
        "random": lambda: rng.random(n) < 0.3,
        "all": lambda: np.ones(n, bool),
        "none": lambda: np.zeros(n, bool),
        "int32": lambda: rng.integers(-2, 3, n).astype(np.int32),
    }[kind]()


@pytest.mark.parametrize("kind", ["random", "all", "none", "int32"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_expand_round_on_planes_matches_reference_kernels(name, kind):
    """The round on the graph's own (P, V_p, K) planes, as ``bfs_cuda``
    hands them to the kernel, against the JAX oracle and Pallas kernel on
    the (N, K) rows in global vertex order."""
    ref_in, port_in = problem(name)
    adj_ref = ref_adj_global(ref_in.g)
    planes = port_in.g.adj
    frontier = frontier_of(kind, adj_ref.shape[0], len(kind))
    want = np.asarray(bfs_expand_reference(adj_ref, frontier.astype(np.int32)))
    np.testing.assert_array_equal(
        np.asarray(bfs_expand_pallas(adj_ref, frontier.astype(np.int32), block_rows=64,
                                     interpret=True)), want)
    f = torch.as_tensor(frontier)
    np.testing.assert_array_equal(bfs_expand_plain(planes, f).numpy(), want)
    np.testing.assert_array_equal(bfs_expand(planes, f, block_rows=33).numpy(), want)


@pytest.mark.parametrize("p,vp,k", [(1, 45, 7), (8, 13, 5), (3, 50, 66)])
def test_expand_round_on_planes_drops_out_of_range(p, vp, k):
    """Planes holding -1 padding, rows of -1 only and ids >= N (dropped, as
    the reference's mode="drop" scatter does), at odd K and N not a multiple
    of 32."""
    n = p * vp
    rng = np.random.default_rng(n + k)
    planes = rng.integers(-1, n + 4, (p, vp, k)).astype(np.int32)
    planes[:, ::4] = -1
    rows = np.transpose(planes, (1, 0, 2)).reshape(n, k)
    frontier = rng.random(n) < 0.5
    want = np.asarray(bfs_expand_reference(rows, frontier.astype(np.int32)))
    np.testing.assert_array_equal(
        np.asarray(bfs_expand_pallas(rows, frontier.astype(np.int32), block_rows=3,
                                     interpret=True)), want)
    got = bfs_expand(torch.as_tensor(planes), torch.as_tensor(frontier), block_rows=3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block_rows", [1, 3, 33, 2048])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_cuda_on_planes_matches_reference_parents(name, block_rows):
    """``bfs_cuda`` (the planes handed over in place) on the CPU: parents
    bit-identical to the JAX ``local`` and ``pallas`` substrates'."""
    _, port_in = problem(name)
    parents = bfs_cuda(port_in.g, port_in.root, block_rows=block_rows).numpy()
    for substrate in ("local", "pallas"):
        p_ref, _ = ref_parents(name, T.Comm.REMOTE_WRITE, substrate)
        np.testing.assert_array_equal(parents, np.asarray(p_ref))


@pytest.mark.parametrize("comm", list(T.Comm))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_traffic_replay_identical(name, comm):
    ref_in, port_in = problem(name)
    st_ref = R.MigratoryStrategy(comm=R.Comm(comm.value))
    ref = R.bfs_traffic(ref_in.g, ref_in.root, st_ref)
    got = T.bfs_traffic(port_in.g, port_in.root, T.MigratoryStrategy(comm=comm))
    assert (got.rounds, got.edges_traversed) == (ref.rounds, ref.edges_traversed)
    assert astuple(got.traffic) == astuple(ref.traffic)
    assert T.bfs_bytes_moved(got.edges_traversed) == R.bfs_bytes_moved(ref.edges_traversed)
    assert T.teps(got.edges_traversed, 0.25) == R.teps(ref.edges_traversed, 0.25)


def _corruptions(parents: np.ndarray, root: int, adj: np.ndarray):
    """Parent arrays the validator must reject or accept, each with the
    reference's verdict computed alongside."""
    reached = np.nonzero((parents >= 0) & (np.arange(len(parents)) != root))[0]
    v, w = int(reached[-1]), int(reached[-2])
    bad_root = parents.copy()
    bad_root[root] = -1
    non_edge = parents.copy()
    non_edge[v] = next(u for u in range(len(parents)) if v not in adj[u] and u != v)
    cycle = parents.copy()
    if v in adj[w] and w in adj[v]:
        cycle[v], cycle[w] = w, v
    orphan = parents.copy()  # v's parent chain leads to an unreached vertex
    unreached = np.nonzero(parents < 0)[0]
    for u in unreached:
        if v in adj[u]:
            orphan[v] = u
            break
    truncated = parents.copy()
    truncated[v] = -1
    return [parents, bad_root, non_edge, cycle, orphan, truncated]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_validate_parents_agrees_with_reference(name):
    ref_in, port_in = problem(name)
    parents = np.array(R.bfs_local(ref_in.g, ref_in.root))
    p, vp, k = port_in.g.adj.shape
    adj = np.transpose(port_in.g.adj.numpy(), (1, 0, 2)).reshape(vp * p, k)
    verdicts = []
    for cand in _corruptions(parents, ref_in.root, adj):
        want = R.validate_parents(ref_in.g, ref_in.root, cand)
        assert T.validate_parents(port_in.g, port_in.root, torch.as_tensor(cand)) == want
        verdicts.append(want)
    assert verdicts[0] and not verdicts[1] and not verdicts[2]


def test_metrics():
    assert T.teps(100, 2.0) == 50.0
    assert T.bfs_effective_bandwidth(10, 1.0) == 16 * 1024 * 16


@pytest.mark.parametrize("scale,edge_factor,seconds", [
    (5, 2, 1e-3), (10, 16, 1.0), (20, 16, 6.11e-4), (26, 8, 3.5), (12, 16, 0.0),
])
def test_bfs_effective_bandwidth_matches_reference(scale, edge_factor, seconds):
    """Paper §5.2's BW at a few scales, edge factors and times (0 s too:
    both clamp the time), equal to the reference's."""
    assert T.bfs_effective_bandwidth(scale, seconds, edge_factor) == R.bfs_effective_bandwidth(
        scale, seconds, edge_factor)
