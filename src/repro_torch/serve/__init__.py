"""Serving of the port: the batched engine and the kNN-LM hook, and the
multi-tenant query front end (admission, coalescing, deadline scheduling)."""
