"""CLI, runtime settings and frame timing."""
