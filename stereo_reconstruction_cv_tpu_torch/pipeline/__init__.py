"""Stage functions of the dense path (the CLI's building blocks)."""
