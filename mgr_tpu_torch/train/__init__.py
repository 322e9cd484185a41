"""Train / eval / predict / decode steps, the optimizer and the fit loop."""
