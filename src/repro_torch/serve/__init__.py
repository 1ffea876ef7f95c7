"""Serving of the port: the batched engine and the kNN-LM hook."""
