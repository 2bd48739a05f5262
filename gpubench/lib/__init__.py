"""The harness: inputs, jobs, traced windows, metric readers, bounds and
the comparison with the reference."""
