"""The offline generative augmentation stages: background removal and
multiview generation."""
