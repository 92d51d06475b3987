"""Training: losses, metrics, the train state with its SGD + staircase
decay optimizer, the train and eval steps, and checkpoints."""
