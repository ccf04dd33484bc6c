"""The SET-MLP model."""
