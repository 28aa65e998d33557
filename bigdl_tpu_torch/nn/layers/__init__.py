"""The layers of the Inception-v1 serving and training paths."""
