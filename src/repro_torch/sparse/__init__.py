"""Sparse containers and the paper's input generators."""
from .csr import CSR, spmv_csr_ref
from .ell import ELL, ell_from_csr, spmv_ell_ref, split_long_rows
from .gen import edges_to_csr, erdos_renyi_edges, laplacian_2d, rmat_edges, skewed_matrix
from .graph import PartitionedGraph, global_id, local_slot, owner_of, partition_graph

__all__ = [
    "CSR", "ELL", "PartitionedGraph", "edges_to_csr", "ell_from_csr", "erdos_renyi_edges",
    "global_id", "laplacian_2d", "local_slot", "owner_of", "partition_graph", "rmat_edges",
    "skewed_matrix", "spmv_csr_ref", "spmv_ell_ref", "split_long_rows",
]
