"""Kernel wrappers with their plain PyTorch versions, and the kernel build."""
