"""BFS frontier expansion."""
