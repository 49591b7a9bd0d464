"""Tensor ops and the kernel wrappers with their plain twins."""
