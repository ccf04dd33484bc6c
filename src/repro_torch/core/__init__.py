"""Element (COO) sparsity, All-ReLU and importance pruning."""
