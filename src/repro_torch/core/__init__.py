"""Sparsity (element and block), All-ReLU, topology evolution and importance pruning."""
