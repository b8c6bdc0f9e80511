"""Config base (numpy/stdlib) and the deferred metrics logger."""
