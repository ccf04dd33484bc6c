"""Step functions of the SET-MLP training loop."""
