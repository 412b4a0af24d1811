"""The BFS op of the benchmark: a Graph500-sized balanced (Erdos-Renyi)
graph as the program's ``PartitionedGraph``, a fixed set of roots each with
one ``BFSInputs`` built at set-up and reused, the frozen §5.2 byte count, and
Graph500's validation of every sampled parent array.

The graph is made on the card from the configuration's ``graph_seed``:
edgefactor * 2^scale endpoint pairs drawn uniformly, symmetrized, self loops
and duplicates dropped. As a Graph500 run searches one generated graph from
many keys, the graph and its search keys are the configuration's, and
``--seed`` sets the order in which the keys are searched and which results
are checked: every seed brings the same work in another order. (Drawn from
the seed, the largest degree K, whose every padded slot the kernel reads,
moved between 62 and 68, and one set of keys searched 9 % faster than
another on the same graph.) Each
vertex's neighbours are sorted and left-packed into (P, V_p, K) planes,
vertex v on nodelet v % P at slot v // P, K the largest degree: the layout
``partition_graph(edges_to_csr(edges, n), P)`` makes of the same edges.
"""
from __future__ import annotations

import time

import torch

from bench.ops import strategy
from bench.reference import bfs as ref
from repro_torch.engine import BFSInputs, Request
from repro_torch.sparse.graph import PartitionedGraph


def bfs_useful_bytes(entries_traversed: int) -> int:
    """Paper §5.2: every traversed adjacency entry reads and writes one
    8-byte word, 16 bytes. Frozen here: it must not move when the program
    does."""
    return entries_traversed * 16


def bfs_roofline_bytes(entries_traversed: int, n: int) -> int:
    """The least a search must move: every adjacency entry of a reached
    vertex read once as an int32 id, and the (n,) int32 parents written once."""
    return entries_traversed * 4 + n * 4


def er_graph(scale: int, edgefactor: int, gen: torch.Generator, device):
    """Sorted unique directed entries of a symmetrized Erdos-Renyi graph:
    (keys = src * n + dst, src, dst), int64."""
    n = 1 << scale
    e = torch.randint(0, n, (2, edgefactor * n), generator=gen, device=device)
    src = torch.cat([e[0], e[1]])
    dst = torch.cat([e[1], e[0]])
    del e
    keep = src != dst
    keys = torch.unique(src[keep] * n + dst[keep])
    return keys, keys // n, keys % n


def partitioned(src: torch.Tensor, dst: torch.Tensor, n: int, p: int) -> PartitionedGraph:
    """(P, V_p, K) int32 planes of sorted (src, dst) entries, -1 padded."""
    deg = torch.bincount(src, minlength=n)
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(src.numel(), device=src.device) - start[src]
    k, vp = int(deg.max()), -(-n // p)
    adj = torch.full((p, vp, k), -1, dtype=torch.int32, device=src.device)
    adj[src % p, src // p, slot] = dst.to(torch.int32)
    planes_deg = torch.zeros((p, vp), dtype=torch.int32, device=src.device)
    v = torch.arange(n, device=src.device)
    planes_deg[v % p, v // p] = deg.to(torch.int32)
    return PartitionedGraph(adj=adj, deg=planes_deg, n_vertices=n)


class Cell:
    """One BFS configuration on one device, seeded."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        self.n = 1 << int(config["scale"])
        self.strategy = strategy(config["strategy"])
        graph_gen = torch.Generator(device=device).manual_seed(int(config["graph_seed"]))
        self.keys, self.src, self.dst = er_graph(int(config["scale"]), int(config["edgefactor"]),
                                                 graph_gen, device)
        self.g = partitioned(self.src, self.dst, self.n, int(config["nodelets"]))
        # Graph500: search keys drawn among vertices of degree >= 1
        has_edge = torch.nonzero(torch.bincount(self.src, minlength=self.n)).squeeze(1)
        pick = torch.randperm(has_edge.numel(), generator=graph_gen, device=device)[: int(config["roots"])]
        self.roots = [int(r) for r in has_edge[pick].tolist()]
        self.inputs = [BFSInputs(self.g, r) for r in self.roots]
        self.tags = len(self.roots)
        self.order = torch.randperm(self.tags, generator=torch.Generator().manual_seed(seed)).tolist()
        self.substrate = None  # set by the harness
        self._levels: "dict[int, torch.Tensor]" = {}

    def request(self, client: int, i: int) -> "tuple[Request, int]":
        """The roots in the seed's order from the client's offset, each
        root's one ``BFSInputs`` object every time (a repeated search from
        fixed keys)."""
        tag = self.order[(client + i) % self.tags]
        return Request("bfs", self.inputs[tag], self.strategy, self.substrate), tag

    def levels(self, tag: int) -> torch.Tensor:
        if tag not in self._levels:
            self._levels[tag] = ref.levels(self.src, self.dst, self.n, self.roots[tag])
        return self._levels[tag]

    def entries_traversed(self, tag: int) -> int:
        """Adjacency entries of every vertex the search reaches."""
        deg = torch.bincount(self.src, minlength=self.n)
        return int(deg[self.levels(tag) >= 0].sum())

    def useful_bytes(self, tag: int) -> int:
        return bfs_useful_bytes(self.entries_traversed(tag))

    def roofline_bytes(self, tag: int) -> int:
        return bfs_roofline_bytes(self.entries_traversed(tag), self.n)

    def check(self, results: "list[tuple[int, torch.Tensor]]") -> "dict[str, float]":
        """The compared numbers of sampled (tag, parents) results."""
        bad = 0
        for tag, par in results:
            bad += ref.bad_vertices(par, self.keys, self.n, self.roots[tag], self.levels(tag))
        return {"bfs_bad_vertices": float(bad)}

    def control(self, tag: int) -> torch.Tensor:
        """The reference in the program's place with one guarantee broken:
        the search stops one round before its frontier empties (a fixed
        round budget), so the deepest level goes unreached."""
        depth = int(self.levels(tag).max())
        return ref.parents(self.src, self.dst, self.n, self.roots[tag], max_rounds=depth - 1)

    def lines(self, medians) -> "list[str]":
        out = [f"bfs: vertices {self.n}, adjacency entries {self.keys.numel()}, "
               f"K {self.g.k}, roots {self.roots}"]
        for tag, root in enumerate(self.roots):
            trav = self.entries_traversed(tag)
            ms = medians.get(tag)
            # Graph500 TEPS counts each undirected edge of the component once
            mteps = f"{trav / 2 / (ms * 1e-3) / 1e6:.1f}" if ms else "none"
            out.append(f"bfs root {root}: depth {int(self.levels(tag).max())}, entries traversed "
                       f"{trav}, useful bytes {self.useful_bytes(tag)} (paper 5.2), median ms "
                       f"{ms}, MTEPS {mteps} (undirected edges / median latency)")
        return out

    def baseline_ms(self) -> float:
        """The plain reference's single-threaded time for one search on the
        host (the first root), the HPC baseline."""
        src, dst = self.src.cpu(), self.dst.cpu()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            t0 = time.perf_counter()
            ref.levels(src, dst, self.n, self.roots[0])
            return (time.perf_counter() - t0) * 1e3
        finally:
            torch.set_num_threads(threads)
