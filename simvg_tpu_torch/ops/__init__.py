"""Tensor operations: boxes, position embeddings and attention."""
