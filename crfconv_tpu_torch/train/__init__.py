"""Training: losses, metrics, the train state with its SGD + staircase
decay optimizer, the train and eval steps, checkpoints, and the experiment
driver (``trainer.Trainer``, the vote test, KITTI's streaming eval, the
CLI ``python -m crfconv_tpu_torch.train``)."""
