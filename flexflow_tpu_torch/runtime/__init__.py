"""Model builder, executor, initializers and weight carry-over."""
