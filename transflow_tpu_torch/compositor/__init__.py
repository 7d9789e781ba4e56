"""Compositor of the port (moveref layers so far)."""
