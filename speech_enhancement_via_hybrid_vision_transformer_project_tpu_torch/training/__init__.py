"""Training: losses, optimizer and schedules, the train/eval steps and the
epoch loop."""
