"""The sequential SET trainer (paper Algorithm 2)."""
