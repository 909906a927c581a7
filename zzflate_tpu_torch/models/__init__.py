"""The two-phase batched DEFLATE encoder."""
