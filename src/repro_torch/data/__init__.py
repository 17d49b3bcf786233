from repro_torch.data.pipeline import synthetic_lm_batches, TokenPipeline  # noqa: F401
