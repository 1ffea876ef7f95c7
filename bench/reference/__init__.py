"""Plain PyTorch DSLSH that the benchmark holds the port to.

It imports nothing of the port: it works the hash keys, tables, heavy
buckets, inner layer, candidates, top-k, votes and the streaming state out
again from the inputs the benchmark hands to both sides.
"""
