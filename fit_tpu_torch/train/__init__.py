"""Training: the train state, the train step and the Trainer."""
