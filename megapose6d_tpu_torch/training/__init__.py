"""Training: configuration, forward loss, optimizer, loop and checkpoints."""
