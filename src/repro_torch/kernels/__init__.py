"""Hand-written CUDA kernels for Hopper (``csrc/``), their Python wrappers
and their plain PyTorch versions: ``spmv`` (blocked ELL and CSR stripes),
``bfs`` (frontier expansion) and ``topk_sim`` (GSANA similarity + top-k)."""
