"""The training data pipeline."""
from .synthetic import DataConfig, SyntheticTokens, for_model
