"""The SpMV op of the benchmark: the paper's 2-D 5-point Laplacian (Figs.
4-6) as the program's ``PartitionedELL`` planes, a pool of x vectors, one
fresh ``SpMVInputs`` a request, the frozen §5.1 byte count, and the check of
every sampled y against the stencil.

The planes are built on the card from the stencil: row r of the n x n grid
holds its existing neighbours among (r-n, r-1, r, r+1, r+n) in that order,
left-packed, -1 and 0 after them, and lives on nodelet r % P at slot r // P.
That is the layout ``partition_ell(laplacian_2d(n), P)`` makes, without the
host's sort of 84 M entries.
"""
from __future__ import annotations

import time

import torch

from bench.ops import strategy
from bench.reference import spmv as ref
from repro_torch.core.spmv import PartitionedELL
from repro_torch.engine import Request, SpMVInputs


def spmv_useful_bytes(nnz: int, n_rows: int, n_cols: int) -> int:
    """Paper §5.1: sizeof(A) (a float32 value and an int32 column index a
    non-zero) + sizeof(x) + sizeof(y), float32. Frozen here: it must not
    move when the program does."""
    return nnz * (4 + 4) + (n_cols + n_rows) * 4


def laplacian_planes(n: int, p: int, device) -> PartitionedELL:
    """The (P, R_p, 5) int32 / float32 planes of the n x n grid's Laplacian."""
    rows = n * n
    if rows % p:
        raise ValueError(f"{rows} rows do not stripe evenly over {p} nodelets")
    r = torch.arange(rows, device=device)
    i, j = r // n, r % n
    cand = torch.stack([r - n, r - 1, r, r + 1, r + n], dim=1)
    valid = torch.stack([i > 0, j > 0, torch.ones_like(i, dtype=torch.bool), j < n - 1, i < n - 1], 1)
    del r, i, j
    weight = torch.tensor([-1.0, -1.0, 4.0, -1.0, -1.0], device=device)
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    cols = torch.where(valid, cand, -1).gather(1, order).to(torch.int32)
    vals = torch.where(valid, weight, 0.0).gather(1, order)
    del cand, valid, order
    stripe = lambda t: t.view(rows // p, p, 5).permute(1, 0, 2).contiguous()  # noqa: E731
    return PartitionedELL(cols=stripe(cols), vals=stripe(vals), shape=(rows, rows))


class Cell:
    """One SpMV configuration on one device, seeded."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        self.n = int(config["grid"])
        self.rows = self.n * self.n
        self.strategy = strategy(config["strategy"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.a = laplacian_planes(self.n, int(config["nodelets"]), device)
        self.xs = torch.randn((int(config["x_pool"]), self.rows), generator=gen, device=device)
        self.nnz = 5 * self.rows - 4 * self.n
        self.tags = self.xs.shape[0]
        self.substrate = None  # set by the harness

    def request(self, client: int, i: int) -> "tuple[Request, int]":
        """A fresh ``SpMVInputs`` every request, as a solver makes each
        iteration; x cycles through the pool from the client's offset."""
        tag = (client + i) % self.tags
        return Request("spmv", SpMVInputs(self.a, self.xs[tag]), self.strategy, self.substrate), tag

    def useful_bytes(self, tag: int) -> int:
        return spmv_useful_bytes(self.nnz, self.rows, self.rows)

    def roofline_bytes(self, tag: int) -> int:
        """The least a product must move: the §5.1 count itself."""
        return self.useful_bytes(tag)

    def unstripe(self, y: torch.Tensor) -> torch.Tensor:
        """(P, R_p) striped y -> (rows,) in row order (row r at r % P, r // P)."""
        return y.T.reshape(-1)[: self.rows]

    def check(self, results: "list[tuple[int, torch.Tensor]]") -> "dict[str, float]":
        """The compared numbers of sampled (tag, y) results."""
        worst = 0.0
        for tag, y in results:
            if y.shape != self.a.cols.shape[:2]:
                return {"spmv_max_rel_err": float("inf")}
            worst = max(worst, ref.max_rel_error(self.unstripe(y), self.xs[tag], self.n))
        return {"spmv_max_rel_err": worst}

    def control(self, tag: int) -> torch.Tensor:
        """The reference in the program's place, in bfloat16, striped as
        the program returns y."""
        y = ref.control(self.xs[tag], self.n)
        p, rp = self.a.cols.shape[:2]
        return y.view(rp, p).T.contiguous()

    def lines(self, medians) -> "list[str]":
        return [f"spmv: rows {self.rows}, nnz {self.nnz}, useful bytes a product "
                f"{self.useful_bytes(0)} (paper 5.1)"]

    def baseline_ms(self) -> float:
        """The plain reference's single-threaded time for one product on
        the host (the x pool's first vector), the HPC baseline."""
        x = self.xs[0].cpu()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            t0 = time.perf_counter()
            ref.laplacian_apply(x, self.n, torch.float32)
            return (time.perf_counter() - t0) * 1e3
        finally:
            torch.set_num_threads(threads)
