"""The paper's SET-MLP configurations."""
