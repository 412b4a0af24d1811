"""Hand-written CUDA kernels for Hopper (``csrc/``), their Python wrappers
and their plain PyTorch versions: ``spmv`` (blocked ELL and CSR stripes),
``bfs`` (frontier expansion), ``topk_sim`` (GSANA similarity + top-k) and
``flash_attention`` (the LM's prefill attention)."""
