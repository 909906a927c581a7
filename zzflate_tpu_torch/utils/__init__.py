"""Containers, profiling and the seeded test corpus."""
