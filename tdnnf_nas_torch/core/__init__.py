"""Config base (numpy/stdlib)."""
