"""The RNNoise model graph."""
