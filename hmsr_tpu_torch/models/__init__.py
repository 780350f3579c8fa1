"""Pipeline stages: alignment, robustness, kernel estimation, merge."""
