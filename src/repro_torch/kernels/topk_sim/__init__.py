"""Fused GSANA similarity + top-k."""
