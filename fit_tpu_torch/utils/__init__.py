"""Device choice, configuration, checkpoints and metrics logging."""
