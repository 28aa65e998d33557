"""The layers of the Inception-v1 serving and training paths, of the
transformer LM's training path, and the within-channel LRN and the
subtractive, divisive and contrastive normalizations."""
