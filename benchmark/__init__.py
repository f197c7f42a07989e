"""The port's benchmark: harness, reference, configurations, cells."""
