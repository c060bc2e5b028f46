from wormhole_tpu_torch.models.linear import LinearConfig, LinearLearner  # noqa: F401
