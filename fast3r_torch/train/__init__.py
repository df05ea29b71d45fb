"""Training: losses, the train step and the training loop."""
