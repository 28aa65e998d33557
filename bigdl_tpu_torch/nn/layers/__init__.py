"""The layers of the Inception-v1 serving and training paths and of the
transformer LM's training path."""
