"""Training of the port: optimizer, state, trainer and the CLI
(``python -m distributed_training_tpu_torch.train``)."""
