"""Single-device codec and the GPU file pipeline."""
