"""Training: AdamW (f32, bf16 or int8 moments), the deterministic synthetic
data pipeline, the train step with gradient accumulation and block remat,
and atomic checkpoints in the reference's file format."""
