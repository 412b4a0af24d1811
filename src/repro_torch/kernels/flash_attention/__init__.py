"""Flash attention: tiled online-softmax attention (GQA, causal, window)."""
